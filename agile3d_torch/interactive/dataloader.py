"""Scene-folder dataset for the interactive annotation tool (the port's own
copy of the JAX package's ``interactive/dataloader.py``): the dataset
directory holds one ``scene_<name>/`` folder per scene with

  scan.ply   — point cloud or mesh (vertices used either way)
  label.ply  — optional ground truth with a 'label' property
  <user>/    — per-user session folder: masks/, clicks/, iou_record.csv,
               objects.npz (saved object semantics)
"""

from __future__ import annotations

import os

import numpy as np

from agile3d_torch.data.ply import read_ply


class InteractiveDataLoader:
    def __init__(self, dataset_path: str, user_name: str = "user"):
        self.dataset_path = dataset_path
        self.user_name = user_name
        self.scene_names = []
        for d in sorted(os.listdir(dataset_path)):
            full = os.path.join(dataset_path, d)
            if os.path.isdir(full) and d.split("_")[0] == "scene":
                self.scene_names.append(
                    os.path.splitext("_".join(d.split("_")[1:]))[0])
        if not self.scene_names:
            raise ValueError(f"no scene_* folders under {dataset_path}")
        self._index = 0
        self._objects = {}       # name -> semantic array [N_full]
        self.load_scene(0)

    def __len__(self):
        return len(self.scene_names)

    @property
    def index(self):
        return self._index

    def load_scene(self, idx: int):
        name = self.scene_names[idx]
        scene_dir = os.path.join(self.dataset_path, "scene_" + name)
        pc, faces = read_ply(os.path.join(scene_dir, "scan.ply"),
                             with_faces=True)
        self.point_type = "mesh" if faces is not None and len(faces) else "pointcloud"
        # triangle indices [F, 3] for surface rendering in the web viewer
        self.faces = (np.asarray(faces, np.uint32)
                      if self.point_type == "mesh" else None)
        self.coords = np.column_stack(
            [pc["x"], pc["y"], pc["z"]]).astype(np.float32)
        if all(k in pc for k in ("R", "G", "B")):
            cols = np.column_stack([pc["R"], pc["G"], pc["B"]])
        elif all(k in pc for k in ("red", "green", "blue")):
            cols = np.column_stack([pc["red"], pc["green"], pc["blue"]])
        else:
            cols = np.full((len(self.coords), 3), 127)
        self.colors = cols.astype(np.float32) / (255.0 if cols.max() > 1 else 1.0)

        label_file = os.path.join(scene_dir, "label.ply")
        self.labels_full = (read_ply(label_file)["label"].astype(np.int32)
                            if os.path.exists(label_file) else None)

        self.exp_folder = os.path.join(scene_dir, self.user_name)
        self.mask_folder = os.path.join(self.exp_folder, "masks")
        self.click_folder = os.path.join(self.exp_folder, "clicks")
        self.record_path = os.path.join(self.exp_folder, "iou_record.csv")
        for p in (self.exp_folder, self.mask_folder, self.click_folder):
            os.makedirs(p, exist_ok=True)

        self._index = idx
        self._objects = {}
        obj_file = os.path.join(self.exp_folder, "objects.npz")
        if os.path.exists(obj_file):
            with np.load(obj_file) as z:
                self._objects = {k: z[k] for k in z.files}
        return name

    # -- object bookkeeping: per-object point masks saved per user --

    @property
    def object_names(self):
        return list(self._objects)

    def add_object(self, name: str):
        if name not in self._objects:
            self._objects[name] = np.zeros(len(self.coords), np.int8)

    def update_object(self, name: str, semantic: np.ndarray):
        self._objects[name] = semantic.astype(np.int8)
        np.savez_compressed(os.path.join(self.exp_folder, "objects.npz"),
                            **self._objects)

    def get_object_semantic(self, name: str):
        return self._objects.get(name)

    def occupied_points_except(self, name: str):
        """Mask of points claimed by other objects (positive semantic)."""
        occ = np.zeros(len(self.coords), bool)
        for other, sem in self._objects.items():
            if other != name:
                occ |= sem == 1
        return occ
