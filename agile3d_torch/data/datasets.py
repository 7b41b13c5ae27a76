"""Multi-object scenes and their collation into padded batches (the
port's own copy of the multi-object half of the JAX package's
``data/datasets.py``).

  scene PLY -> min-shift -> (train) flips + z-rotations -> voxelize
  -> coordinate pyramid + kernel maps -> bucket padding.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from agile3d_torch.config import DEFAULT_VOXEL_BUCKETS, bucket_size
from agile3d_torch.data.ply import read_ply
from agile3d_torch.sparse.grid import PaddedPyramid, pad_features, pad_pyramid
from agile3d_torch.sparse.kernel_maps import build_pyramid
from agile3d_torch.sparse.quantize import sparse_quantize


class SceneSample(NamedTuple):
    vox_coords: np.ndarray    # int32 [N, 3]
    raw_coords: np.ndarray    # float32 [N, 3]
    feats: np.ndarray         # float32 [N, 3] colors / 255
    labels: np.ndarray        # int32 [N] voxel labels
    labels_full: np.ndarray   # int32 [N_full]
    inverse_map: np.ndarray   # int64 [N_full]
    click_idx: dict           # pre-recorded clicks (verification only)
    scene_name: str
    num_obj: int


class SceneBatch(NamedTuple):
    pyramid: PaddedPyramid
    feats: np.ndarray         # [N0_pad, 3] flat
    raw: np.ndarray           # [N0_pad, 3] flat
    sample_idx: np.ndarray    # int32 [B, Ns_pad] flat rows, -1 pad
    labels: np.ndarray        # int32 [B, Ns_pad], -1 pad
    num_obj: np.ndarray       # int32 [B]
    labels_full: list         # per-sample full-res labels
    inverse_map: list         # per-sample voxel row per point
    scene_names: list
    obj_tags: list            # per-sample num_obj


def augment_coords(coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Train-time augmentation: random YZ / XZ flips, a 90-degree
    z-rotation and a uniform z-rotation, drawn from ``rng`` in the JAX
    package's order (so one seed gives the same coordinates)."""
    out = coords.copy()
    if rng.random() > 0.5:
        out[:, 0] = -out[:, 0]
    if rng.random() > 0.5:
        out[:, 1] = -out[:, 1]

    def rotz(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    out = out @ rotz(rng.choice([0, np.pi / 2, np.pi, 3 * np.pi / 2])).T
    out = out @ rotz(rng.random() * 2 * np.pi - np.pi).T
    return out.astype(np.float32)


def _load_scan(path: str):
    pc = read_ply(path)
    coords = np.column_stack([
        pc["x"] - pc["x"].min(),
        pc["y"] - pc["y"].min(),
        pc["z"] - pc["z"].min(),
    ]).astype(np.float32)
    colors = np.column_stack([pc["R"], pc["G"], pc["B"]]).astype(np.float32) / 255.0
    labels = pc["label"].astype(np.int32)
    return coords, colors, labels


class InterMultiObjDataset:
    """Multi-object scenes listed in a train / val json
    {scene_obj_N: {'obj': {new_id: orig_id}, 'clicks': {...}} | {}}.
    ``augment`` applies ``augment_coords`` with a generator seeded once
    from ``seed``."""

    def __init__(self, scan_folder, scene_list, quantization_size,
                 augment=False, seed=0):
        self.scan_folder = scan_folder
        with open(scene_list) as f:
            self.data_samples = json.load(f)
        self.keys = list(self.data_samples)
        self.quantization_size = quantization_size
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i) -> SceneSample:
        sample_name = self.keys[i]
        scene_name, num_obj = sample_name.split("_obj_")
        coords, colors, labels_full = _load_scan(
            os.path.join(self.scan_folder, scene_name + ".ply"))
        if self.augment:
            coords = augment_coords(coords, self.rng)

        spec = self.data_samples[sample_name]
        if spec:
            remapped = np.zeros_like(labels_full)
            for new_id, orig_id in spec["obj"].items():
                remapped[labels_full == orig_id] = int(new_id)
            labels_full = remapped

        vox, unique_map, inverse_map = sparse_quantize(
            coords, self.quantization_size)
        labels_qv = labels_full[unique_map]

        click_idx = spec.get("clicks", {}) if spec else {}
        if click_idx:
            # Recorded clicks are rows of the reference's first-occurrence
            # voxel order; ours are key-sorted, so translate through fo.
            fo = np.argsort(unique_map, kind="stable")
            click_idx = {
                obj_id: [int(fo[r]) for r in rows]
                for obj_id, rows in click_idx.items()
            }
        for obj_id, rows in click_idx.items():
            if not np.all(labels_qv[rows] == int(obj_id)):
                raise ValueError(
                    f"{sample_name}: pre-recorded clicks disagree with labels")

        return SceneSample(
            vox_coords=vox, raw_coords=coords[unique_map],
            feats=colors[unique_map], labels=labels_qv.astype(np.int32),
            labels_full=labels_full.astype(np.int32),
            inverse_map=inverse_map, click_idx=click_idx,
            scene_name=scene_name, num_obj=int(num_obj))


def collate_scenes(samples: list[SceneSample],
                   buckets=DEFAULT_VOXEL_BUCKETS) -> SceneBatch:
    """Concatenate samples into one flat padded pyramid plus per-sample
    padded row maps."""
    counts = [len(s.vox_coords) for s in samples]
    vox = np.vstack([s.vox_coords for s in samples])
    batch_ids = np.repeat(np.arange(len(samples), dtype=np.int32), counts)
    pyr = pad_pyramid(build_pyramid(vox, batch_ids), buckets)
    n0 = pyr.levels[0].grid.shape[0]

    feats = pad_features(
        np.vstack([s.feats for s in samples]).astype(np.float32), n0)
    raw = pad_features(
        np.vstack([s.raw_coords for s in samples]).astype(np.float32), n0)

    ns = bucket_size(max(counts), buckets)
    b = len(samples)
    sample_idx = np.full((b, ns), -1, np.int32)
    labels = np.full((b, ns), -1, np.int32)
    offset = 0
    for i, s in enumerate(samples):
        c = counts[i]
        sample_idx[i, :c] = np.arange(offset, offset + c, dtype=np.int32)
        labels[i, :c] = s.labels
        offset += c

    return SceneBatch(
        pyramid=pyr, feats=feats, raw=raw, sample_idx=sample_idx,
        labels=labels, num_obj=np.array([s.num_obj for s in samples], np.int32),
        labels_full=[s.labels_full for s in samples],
        inverse_map=[s.inverse_map for s in samples],
        scene_names=[s.scene_name for s in samples],
        obj_tags=[s.num_obj for s in samples])


def build_dataset(split: str, mode: str, *, scan_folder, scene_list,
                  voxel_size=0.05, seed=0):
    """The dataset of one split: ``train`` augments. Multi-object only
    (the single-object protocol is not ported yet)."""
    if mode != "multi_obj":
        raise ValueError(f"dataset mode {mode} not supported")
    return InterMultiObjDataset(scan_folder, scene_list, voxel_size,
                                augment=split == "train", seed=seed)
