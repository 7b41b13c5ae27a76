"""Interactive annotation model server (counterpart of the JAX package's
``interactive/server.py``).

Per scene it quantizes once, runs the backbone once and uploads the
scene's full-resolution labels and inverse map once; then it serves
``get_next_click``, the per-click path that PERF.md's < 50 ms p50 limit is
for. A click is one upload (the click table and the object count), then
on the device the decoder, the clicked-voxel override, devoxelisation and
the mean IoU, then one readback of the uint8 masks and the IoU. Clicks
come in the reference tool's dict-of-lists form ``{obj_id: [voxel rows]}``
so that a client stays thin.

The JAX server also compiles its click step for every click bucket on a
thread after each scene load (``_warm_decoder_async``); the port runs
eager PyTorch and has no compiled binaries to warm, so it has no such
step. The bf16 copy of the decoder's weights (``decoder_dtype=
"bfloat16"``, the serving default of ``run_ui``) is made once, when the
server starts.

Session artifacts match the reference tool's: per-click ``iou_record.csv``
lines and mask / click ``.npy`` dumps in the user's folder.
"""

from __future__ import annotations

import os
import threading
from datetime import datetime

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import SceneSample, collate_scenes
from agile3d_torch.engine.clicks import click_override_device, mean_iou
from agile3d_torch.engine.eval import InteractiveEngine
from agile3d_torch.interactive.dataloader import InteractiveDataLoader
from agile3d_torch.models.agile3d import ClickState, init_agile3d
from agile3d_torch.sparse.quantize import sparse_quantize
from agile3d_torch.utils.ckpt import load_checkpoint
from agile3d_torch.utils.profiling import annotate


def clicks_dict_to_arrays(click_idx: dict, click_time_idx: dict,
                          max_clicks: int):
    """{obj_id: [voxel rows]} and {obj_id: [click times]} -> padded
    (vox, obj, time) int32 arrays of ``max_clicks`` slots, -1 = unused."""
    vox = np.full(max_clicks, -1, np.int32)
    obj = np.zeros(max_clicks, np.int32)
    tim = np.zeros(max_clicks, np.int32)
    slot = 0
    for obj_id, rows in click_idx.items():
        times = click_time_idx[obj_id]
        for r, t in zip(rows, times):
            if slot >= max_clicks:
                raise ValueError(f"click budget {max_clicks} exceeded")
            vox[slot], obj[slot], tim[slot] = r, int(obj_id), t
            slot += 1
    return vox, obj, tim


class InteractiveSegmentationServer:
    """The model side of the annotation tool. ``weights``: a reference
    ``.pth``; without one the weights are random, drawn from ``seed``."""

    def __init__(self, dataloader: InteractiveDataLoader,
                 weights: str | None = None, cfg: Config = Config(),
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self.loader = dataloader
        model = init_agile3d(cfg.model, seed=seed, device="cpu")
        if weights:
            load_checkpoint(weights, model)
        self.engine = InteractiveEngine(cfg, model, device)
        with torch.no_grad():
            self.engine.model._decoder_weights()
        self.scene = None
        # Serializes scene state against the per-click path: web.py serves
        # from a ThreadingHTTPServer, so a /click racing a /scene/next would
        # otherwise pair a new scene with stale device arrays.
        self._lock = threading.RLock()
        self.load_scene(dataloader.index)

    # -- scene lifecycle --

    def load_scene(self, idx: int):
        with annotate("agile3d.server.load_scene"), self._lock, \
                torch.inference_mode():
            return self._load_scene_locked(idx)

    def _load_scene_locked(self, idx: int):
        with annotate("agile3d.data.prepare"):
            name = self.loader.load_scene(idx)
            coords, colors = self.loader.coords, self.loader.colors
            shifted = coords - coords.min(0, keepdims=True)
            vox, unique_map, inverse_map = sparse_quantize(
                shifted, self.cfg.model.voxel_size)
            labels_full = self.loader.labels_full
            sample = SceneSample(
                vox_coords=vox, raw_coords=shifted[unique_map],
                feats=colors[unique_map],
                labels=(labels_full[unique_map].astype(np.int32)
                        if labels_full is not None
                        else np.zeros(len(vox), np.int32)),
                labels_full=(labels_full.astype(np.int32)
                             if labels_full is not None
                             else np.zeros(len(coords), np.int32)),
                inverse_map=inverse_map, click_idx={}, scene_name=name,
                num_obj=0)
            self.sample = sample
            self.batch = collate_scenes([sample], self.cfg.buckets)
        self.scene = self.engine.run_backbone(self.batch)
        self.n_valid = len(vox)
        # full-resolution arrays on the device, once per scene
        dev = self.engine.device
        self._labels_full = torch.from_numpy(sample.labels_full).to(dev)
        self._inverse_map = torch.from_numpy(
            sample.inverse_map.astype(np.int64)).to(dev)
        self._n_full = len(sample.labels_full)
        return name

    def next_scene(self):
        if self.loader.index + 1 < len(self.loader):
            return self.load_scene(self.loader.index + 1)
        return None

    def previous_scene(self):
        if self.loader.index > 0:
            return self.load_scene(self.loader.index - 1)
        return None

    def nearest_voxel(self, xyz: np.ndarray) -> int:
        """World position -> voxel row (the GUI's depth-unproject lookup)."""
        with annotate("agile3d.server.nearest_voxel"), self._lock:
            shifted = xyz - self.loader.coords.min(0)
            d = np.sum((self.sample.raw_coords - shifted[None, :]) ** 2,
                       axis=1)
            return int(np.argmin(d))

    # -- the per-click path --

    def get_next_click(self, click_idx: dict, click_time_idx: dict,
                       record: bool = True, return_voxel: bool = False):
        """One decoder round for the current click set. Returns
        (pred_full [N_full], mean_iou | None) or, with ``return_voxel``,
        (pred_vox [N_vox], pred_full, mean_iou | None), the masks as uint8
        object ids. Runs under ``torch.inference_mode`` in the calling
        thread (grad mode is per thread, and web.py calls from handler
        threads)."""
        with self._lock, torch.inference_mode(), \
                annotate("agile3d.server.click"):
            return self._get_next_click_locked(
                click_idx, click_time_idx, record, return_voxel)

    def _get_next_click_locked(self, click_idx, click_time_idx, record,
                               return_voxel):
        vox, obj, tim = clicks_dict_to_arrays(
            click_idx, click_time_idx, self.cfg.model.max_clicks)
        count = int((vox >= 0).sum())
        mc = self.engine._click_bucket(count)
        num_obj = max([int(k) for k in click_idx] + [1])
        packed = np.concatenate([vox[:mc], obj[:mc], tim[:mc], [num_obj]])
        packed = torch.from_numpy(packed.astype(np.int32)).to(
            self.engine.device)
        clicks = ClickState(*(packed[i * mc:(i + 1) * mc][None]
                              for i in range(3)))
        out = self.engine.model.forward_mask(self.scene, clicks, packed[-1:])
        pred = out["pred_masks"][0].argmax(-1).to(torch.int32)
        pred = click_override_device(pred, clicks.vox[0], clicks.obj[0])
        pred_full = pred[self._inverse_map]
        iou = mean_iou(pred_full, self._labels_full,
                       self.cfg.model.max_fg_objects)
        # one readback: object ids <= max_fg_objects fit in uint8, the IoU
        # rides along as its four bytes
        buf = torch.cat([pred[:self.n_valid].to(torch.uint8),
                         pred_full.to(torch.uint8),
                         iou.float().reshape(1).view(torch.uint8)])
        with annotate("agile3d.engine.wait"):
            buf = buf.cpu().numpy()
        pred_vox = buf[:self.n_valid]
        pred_full = buf[self.n_valid:self.n_valid + self._n_full]
        iou = (float(buf[-4:].view(np.float32)[0])
               if self.loader.labels_full is not None else None)
        if record:
            self._record(click_idx, click_time_idx, pred_full, iou)
        if return_voxel:
            return pred_vox, pred_full, iou
        return pred_full, iou

    def _record(self, click_idx, click_time_idx, pred_full, iou):
        with annotate("agile3d.server.record"):
            num_obj = max(len(click_idx) - 1, 1)
            num_click = sum(len(c) for c in click_idx.values())
            avg = round(num_click / num_obj, 1)
            iou_str = "NA" if iou is None else str(round(iou * 100, 1))
            stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            line = (f"{stamp}  {self.sample.scene_name}  "
                    f"NumObjects:{num_obj}  AvgNumClicks:{avg}  "
                    f"mIoU:{iou_str}\n")
            with open(self.loader.record_path, "a") as f:
                f.write(line)
            np.save(os.path.join(self.loader.mask_folder,
                                 f"mask_{avg}_{iou_str}.npy"), pred_full)
            np.save(os.path.join(self.loader.click_folder,
                                 f"click_{avg}_{iou_str}.npy"),
                    {"click_idx": click_idx, "click_time": click_time_idx},
                    allow_pickle=True)
