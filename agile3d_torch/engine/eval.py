"""Interactive evaluation rollout with the host loop (counterpart of the
host-rollout path of the JAX package's ``engine/eval.py``).

Per scene: run the backbone once, then iterate click rounds -- decoder
forward, clicked-voxel override, full-resolution IoU, click simulation --
until the click budget is spent, writing one ``id scene obj clicks iou``
CSV row per round. The model passes, IoU and boundary distances run on the
engine's device; loop control and CSV writing stay on the host.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import SceneBatch, collate_scenes
from agile3d_torch.engine.clicks import (
    HostClicks,
    apply_click_override,
    iou_per_object,
    simulate_clicks,
)
from agile3d_torch.models.agile3d import Agile3D, ClickState
from agile3d_torch.sparse.grid import to_device


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    if dev.type == "cuda":
        # f32 parity: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def stack_clicks(clicks: list[HostClicks], mc: int, device) -> ClickState:
    """The first ``mc`` slots of each sample's click table as one
    [B, mc] ClickState on ``device``."""
    return ClickState(*(torch.from_numpy(np.stack([getattr(c, f)[:mc]
                                                   for c in clicks])).to(device)
                        for f in ("vox", "obj", "time")))


class InteractiveEngine:
    """Holds the model on its device and the per-batch device transfer."""

    CLICK_BUCKETS = (32, 64, 128, 256)

    def __init__(self, cfg: Config, model: Agile3D, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._dev_batch = None
        self._dev_cache = None

    def device_batch(self, batch: SceneBatch):
        """(pyramid, feats, raw, sample_idx) of ``batch`` on the device,
        transferred once per batch object."""
        if self._dev_batch is not batch:
            dev = self.device
            self._dev_cache = (
                to_device(batch.pyramid, dev),
                torch.from_numpy(batch.feats).to(dev),
                torch.from_numpy(batch.raw).to(dev),
                torch.from_numpy(batch.sample_idx).to(dev))
            self._dev_batch = batch
        return self._dev_cache

    @torch.no_grad()
    def run_backbone(self, batch: SceneBatch, training: bool = False):
        """Scene features of ``batch``. ``training`` normalises with the
        batch's statistics, as the supervised step will; the new running
        statistics are dropped (the step commits its own)."""
        pyr, feats, raw, sample_idx = self.device_batch(batch)
        return self.model.forward_backbone(pyr, feats, raw, sample_idx,
                                           {} if training else None)

    def _click_bucket(self, count: int) -> int:
        for b in self.CLICK_BUCKETS:
            if count <= b <= self.cfg.model.max_clicks:
                return b
        return self.cfg.model.max_clicks

    @torch.no_grad()
    def run_mask(self, scene, clicks: HostClicks, num_obj: int):
        """Decoder pass over the live click table, sliced to the smallest
        click bucket that holds it. Returns (outputs, argmax labels [B, N])."""
        dev = self.device
        cs = stack_clicks([clicks], self._click_bucket(clicks.count), dev)
        out = self.model.forward_mask(
            scene, cs, torch.tensor([num_obj], dtype=torch.int32, device=dev))
        return out, out["pred_masks"].argmax(dim=-1)

    @torch.no_grad()
    def run_mask_batch(self, scene, clicks: list[HostClicks],
                       num_obj: np.ndarray) -> torch.Tensor:
        """One decoder pass for a batch of samples (the training rollout),
        each sample's click table sliced to the bucket of the largest.
        Returns the argmax labels [B, N] on the device."""
        dev = self.device
        cs = stack_clicks(clicks, self._click_bucket(max(c.count for c in clicks)),
                          dev)
        out = self.model.forward_mask(
            scene, cs, torch.from_numpy(np.asarray(num_obj, np.int32)).to(dev))
        return out["pred_masks"].argmax(dim=-1)

    @torch.no_grad()
    def scene_iou(self, pred_vox: np.ndarray, inverse_map: np.ndarray,
                  labels_full: np.ndarray) -> float:
        """Devoxelized mean IoU over the objects present in the labels."""
        pred_full = torch.from_numpy(pred_vox[inverse_map]).to(self.device)
        lab = torch.from_numpy(labels_full).to(self.device)
        valid = torch.ones_like(lab, dtype=torch.bool)
        ious, present = iou_per_object(pred_full, lab, valid,
                                       self.cfg.model.max_fg_objects)
        mean = torch.where(present, ious, torch.zeros_like(ious)).sum() \
            / torch.clamp(present.sum(), min=1)
        return float(mean)


def evaluate_scene(engine: InteractiveEngine, batch: SceneBatch, *,
                   instance_id: int, rng: random.Random,
                   max_num_clicks: int = 20) -> list[str]:
    """The multi-object click rollout of one scene (batch size 1). Returns
    CSV rows ``id scene obj clicks iou``. Once no voxel is wrong, the
    remaining rounds repeat the converged IoU without running the model."""
    if len(batch.scene_names) != 1:
        raise ValueError("eval runs one scene per batch")
    cfg = engine.cfg
    scene = engine.run_backbone(batch)

    n_valid = int((batch.sample_idx[0] >= 0).sum())
    labels_v = batch.labels[0, :n_valid]
    raw_v = batch.raw[:n_valid]
    num_obj = int(batch.num_obj[0])
    tag = batch.obj_tags[0]
    scene_name = batch.scene_names[0].replace("scene", "")

    clicks = HostClicks(cfg.model.max_clicks)
    budget = num_obj * max_num_clicks
    current = 0
    rows = []
    converged_iou = None
    while current <= budget:
        if current == 0:
            pred = np.zeros(n_valid, np.int32)
        elif converged_iou is None:
            _, pred_dev = engine.run_mask(scene, clicks, num_obj)
            pred = pred_dev[0, :n_valid].cpu().numpy().astype(np.int32)
            pred = apply_click_override(pred, clicks)

        if converged_iou is None:
            iou = engine.scene_iou(pred, batch.inverse_map[0],
                                   batch.labels_full[0])
        else:
            iou = converged_iou
        rows.append(f"{instance_id} {scene_name} {tag} {current / num_obj} {iou}")

        if converged_iou is None:
            new = simulate_clicks(
                pred, labels_v, raw_v, num_obj=num_obj, training=False,
                current_num_clicks=current, rng=rng, device=engine.device,
                max_label=cfg.model.max_fg_objects)
            if new is not None:
                clicks.extend(new)
            else:
                # nothing left to correct: every later round repeats this one
                converged_iou = iou
        current += num_obj if current == 0 else 1
    return rows


def evaluate_dataset(engine: InteractiveEngine, dataset, results_file: str, *,
                     max_num_clicks: int = 20, seed: int = 42,
                     log=print) -> str:
    """Scenes in order, one CSV; the caller runs the evaluator on it. Logs
    the final IoU of every tenth scene."""
    rng = random.Random(seed)
    with open(results_file, "w") as f:
        for i in range(len(dataset)):
            batch = collate_scenes([dataset[i]], engine.cfg.buckets)
            rows = evaluate_scene(engine, batch, instance_id=i, rng=rng,
                                  max_num_clicks=max_num_clicks)
            f.write("\n".join(rows) + "\n")
            if i % 10 == 0:
                log(f"[{i + 1}/{len(dataset)}] {batch.scene_names[0]} "
                    f"final IoU {float(rows[-1].split(' ')[4]):.4f}")
    return results_file
