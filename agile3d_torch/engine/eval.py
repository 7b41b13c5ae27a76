"""Interactive evaluation rollout (counterpart of the JAX package's
``engine/eval.py``).

Per scene: run the backbone once, then iterate click rounds -- decoder
forward, clicked-voxel override, full-resolution IoU, click simulation --
until the click budget is spent, writing one ``id scene obj clicks iou``
CSV row per round. ``mode="multi"`` budgets ``max_num_clicks`` per object
and writes clicks per object; ``mode="single"`` (the InterObject3D
protocol, binarised labels) budgets ``max_num_clicks`` in all, one click a
round, and writes the absolute click count. ``evaluate_dataset`` runs the rounds on the device by
default (``engine/device_eval.py``); ``evaluate_scene`` here is the host
loop, whose model passes, IoU and boundary distances run on the engine's
device while loop control and CSV writing stay on the host. Scenes are
prepared on a background thread (``data/prefetch.py``, depth 2) while the
card runs the scene before.

Before any backbone work, ``check_single_chip_rows`` holds the scene's
padded row count against the card's memory (``utils/costs.py``): a scene
over the budget raises ``SceneTooLargeError`` and the CLIs exit with one
``error:`` line instead of running out of device memory mid-UNet (the
voxel-sharded backbone, which exists for such scenes, skips the check).

``InteractiveEngine(sp=N)`` shards the voxel axis over the N ranks of a
``torch.distributed`` group (``parallel/``); ``evaluate_dataset_parallel``
evaluates scenes on several devices at once, a thread each.
"""

from __future__ import annotations

import copy
import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import SceneBatch, collate_scenes
from agile3d_torch.data.prefetch import BatchPrefetcher
from agile3d_torch.engine.clicks import (
    HostClicks,
    apply_click_override,
    click_column,
    click_schedule,
    mean_iou,
    simulate_clicks,
)
from agile3d_torch.engine.device_eval import evaluate_scene_device
from agile3d_torch.models.agile3d import Agile3D, ClickState
from agile3d_torch.models.criterion import (
    click_loss_weights,
    criterion_forward,
    loss_weight_dict,
    model_num_aux_rounds,
    total_loss,
)
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.costs import SINGLE_CHIP_HBM_GIB, eval_hbm_gib


class SceneTooLargeError(ValueError):
    """A scene's padded voxel count exceeds the card's memory budget.

    Raised by ``check_single_chip_rows`` with the remedies in the message;
    the CLIs catch it and exit with that one line (the reference's answer
    to a huge scan is "crop", demo.md:39,70)."""


def check_single_chip_rows(n_rows: int) -> None:
    """Hold the eval footprint estimated at this padded level-0 row count
    (``utils/costs.py::eval_hbm_gib``, anchored on a measurement on the
    card) against one card's memory, or ``AGILE3D_HBM_GIB`` GiB where that
    is set (the only override)."""
    budget = float(os.environ.get("AGILE3D_HBM_GIB", SINGLE_CHIP_HBM_GIB))
    est = eval_hbm_gib(n_rows)
    if est > budget:
        raise SceneTooLargeError(
            f"scene pads to {n_rows} voxel rows (~{est:.1f} GiB estimated "
            f"eval footprint > {budget:.2f} GiB on one card): rerun with "
            f"--sp N --sp_backbone to shard the voxel axis over N cards, "
            f"crop the scan (reference demo.md guidance), or raise the voxel "
            f"size (--voxel_size)")


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
    """Holds the model on its device and the per-batch device transfer.

    ``sp`` > 1 shards the decoder's voxel axis over the ``sp`` ranks of the
    current ``torch.distributed`` group (``parallel/sp.py``; every rank
    builds its engine): the host loop (``run_mask``) and the device rollout
    both take it. ``sp_backbone`` also shards the backbone
    (``parallel/sp_backbone.py``; needs ``sp`` > 1, one scene with the
    identity per-sample map); without it every rank runs the whole
    backbone and keeps its rows. The sharded scene, and the partitioned
    pyramid, are kept per scene."""

    CLICK_BUCKETS = (32, 64, 128, 256)

    def __init__(self, cfg: Config, model: Agile3D, device="cuda", sp: int = 1,
                 sp_backbone: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._dev_batch = None
        self._dev_cache = None
        self.sp = sp
        self.sp_backbone = sp_backbone
        if sp_backbone and sp <= 1:
            raise ValueError("sp_backbone requires sp > 1")
        if sp > 1:
            from agile3d_torch.parallel.mesh import make_mesh
            from agile3d_torch.parallel.sp import make_forward_mask_sp

            self.sp_mesh = make_mesh(n_dp=1, n_sp=sp, device=self.device)
            self._fm_sp, self._shard_scene = make_forward_mask_sp(
                self.sp_mesh, cfg.model)
            self._sp_scene = (None, None)
            if sp_backbone:
                from agile3d_torch.parallel.sp_backbone import (
                    make_forward_backbone_sp,
                )

                self._bb_sp = make_forward_backbone_sp(self.sp_mesh,
                                                       cfg.model)
                self._sp_pyr = (None, None)

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
        """Scene features of ``batch``: of this rank's rows under
        ``sp_backbone`` (eval), else of the whole scene. ``training``
        normalises with the batch's statistics, as the supervised step
        will; the new running statistics are dropped (the step commits its
        own). Raises ``SceneTooLargeError`` before any transfer when the
        scene is over the card's memory budget (not under ``sp_backbone``,
        which exists for such scenes)."""
        if self.sp_backbone and not training:
            return self._run_backbone_sp(batch)
        check_single_chip_rows(batch.pyramid.levels[0].grid.shape[0])
        pyr, feats, raw, sample_idx = self.device_batch(batch)
        return self.model.forward_backbone(pyr, feats, raw, sample_idx,
                                           {} if training else None)

    def _run_backbone_sp(self, batch: SceneBatch):
        """The voxel-sharded backbone: the pyramid partitioned over the sp
        ranks (once per batch) and the halo-exchange UNet."""
        from agile3d_torch.parallel.sp import shard_rows
        from agile3d_torch.parallel.sp_backbone import (
            local_pyramid,
            partition_pyramid,
        )

        if batch.sample_idx.shape[0] != 1:
            raise ValueError("sp_backbone runs one scene (B = 1), the eval "
                             "case it exists for")
        nv = batch.pyramid.levels[0].num_valid
        si = batch.sample_idx[0]
        if not (np.array_equal(si[:nv], np.arange(nv, dtype=si.dtype))
                and (si[nv:] == -1).all()
                and len(si) == batch.pyramid.levels[0].grid.shape[0]):
            raise ValueError("sp_backbone requires the identity per-sample "
                             "map (single-scene collation)")
        axis = self.sp_mesh["sp"]
        if self._sp_pyr[0] is not batch:
            sp_pyr = partition_pyramid(batch.pyramid, self.sp)
            self._sp_pyr = (batch, local_pyramid(sp_pyr, axis, self.device))
        rows = lambda a: shard_rows(torch.from_numpy(a), axis, 0).to(
            self.device)
        scene = self._bb_sp(self.model, self._sp_pyr[1], rows(batch.feats),
                            rows(batch.raw))
        self._sp_scene = (scene, scene)
        return scene

    def sp_scene(self, scene):
        """This rank's rows of ``scene`` (kept per scene); a scene from the
        sharded backbone is one already."""
        if self._sp_scene[0] is not scene:
            self._sp_scene = (scene, self._shard_scene(scene))
        return self._sp_scene[1]

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
        num_obj_dev = torch.tensor([num_obj], dtype=torch.int32, device=dev)
        if self.sp > 1:
            # the masks of this rank's rows; every rank reads the whole
            # prediction, as JAX's host reads the whole sharded array
            from agile3d_torch.parallel.mesh import all_gather

            out = self._fm_sp(self.model, self.sp_scene(scene), cs,
                              num_obj_dev)
            pred = out["pred_masks"].argmax(dim=-1).to(torch.int32)
            return out, all_gather(pred.T.contiguous(),
                                   self.sp_mesh["sp"]).T
        out = self.model.forward_mask(scene, cs, num_obj_dev)
        return out, out["pred_masks"].argmax(dim=-1)

    @torch.no_grad()
    def val_losses(self, out: dict, scene, clicks: HostClicks,
                   labels: np.ndarray) -> dict:
        """One round's validation losses (the JAX package's
        ``_val_losses``, reference engine.py:236-246): the criterion on the
        pass's ``all_masks`` against ``labels`` (the scene's valid voxels'
        labels, padded with -1 to the pass's rows), click-weighted by the
        click table at the pass's bucket. Returns {"loss": the weighted
        total, "loss_bce", "loss_dice" (those configured)} as floats."""
        cfg = self.cfg
        dev = self.device
        cs = stack_clicks([clicks], self._click_bucket(clicks.count), dev)
        pad = np.full(scene.vox_valid.shape[1], -1, np.int32)
        pad[: len(labels)] = labels
        lab = torch.from_numpy(pad[None]).to(dev)
        vox_valid = scene.vox_valid & (lab >= 0)
        weights = click_loss_weights(scene.raw, vox_valid, cs.vox, cs.vox >= 0,
                                     cfg.loss)
        losses = criterion_forward(out["all_masks"], lab.clamp(min=0), weights,
                                   vox_valid, cfg.loss)
        wd = loss_weight_dict(cfg.loss,
                              num_aux_rounds=model_num_aux_rounds(cfg.model))
        return {"loss": float(total_loss(losses, wd)),
                **{k: float(v) for k, v in losses.items()
                   if k in ("loss_bce", "loss_dice")}}

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
        return float(mean_iou(pred_full, lab, self.cfg.model.max_fg_objects))


def evaluate_scene(engine: InteractiveEngine, batch: SceneBatch, *,
                   instance_id: int, rng: random.Random,
                   max_num_clicks: int = 20, mode: str = "multi",
                   loss_meter=None) -> list[str]:
    """The click rollout of one scene (batch size 1) in the ``mode``
    protocol. Returns CSV rows ``id scene obj clicks iou``. Once no voxel
    is wrong, the remaining rounds repeat the converged IoU without running
    the model. ``loss_meter`` (a ``utils/misc.py::MetricLogger``) gets each
    model round's validation losses (``InteractiveEngine.val_losses``)."""
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
    budget, first = click_schedule(mode, num_obj, max_num_clicks)
    current = 0
    rows = []
    converged_iou = None
    while current <= budget:
        if current == 0:
            pred = np.zeros(n_valid, np.int32)
        elif converged_iou is None:
            out, pred_dev = engine.run_mask(scene, clicks, num_obj)
            pred = pred_dev[0, :n_valid].cpu().numpy().astype(np.int32)
            pred = apply_click_override(pred, clicks)
            if loss_meter is not None:
                loss_meter.update(**engine.val_losses(out, scene, clicks,
                                                      labels_v))

        if converged_iou is None:
            iou = engine.scene_iou(pred, batch.inverse_map[0],
                                   batch.labels_full[0])
        else:
            iou = converged_iou
        rows.append(f"{instance_id} {scene_name} {tag} "
                    f"{click_column(mode, current, num_obj)} {iou}")

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
        current += first if current == 0 else 1
    return rows


def evaluate_dataset(engine: InteractiveEngine, dataset, results_file: str, *,
                     max_num_clicks: int = 20, seed: int = 42,
                     log=print, device_rollout: bool = True,
                     mode: str = "multi", loss_meter=None) -> str:
    """Scenes in order, one CSV, in the ``mode`` protocol; the caller runs
    the evaluator on it. Logs the final IoU of every tenth scene.
    ``device_rollout`` runs each scene's rounds >= 1 on the device
    (``evaluate_scene_device``), else the host loop (``evaluate_scene``);
    the rows are the same. Up to two scenes ahead are loaded and collated
    on a host thread while a scene runs (val datasets draw nothing while
    loading, so the rows do not change). ``loss_meter`` collects the
    validation losses, on the host loop only (where the JAX package
    computes them)."""
    if device_rollout and loss_meter is not None:
        raise ValueError("the validation losses are computed on the host "
                         "loop: pass device_rollout=False with loss_meter")
    scene_fn = evaluate_scene_device if device_rollout else evaluate_scene
    extra = {} if loss_meter is None else {"loss_meter": loss_meter}
    rng = random.Random(seed)
    fetcher = BatchPrefetcher(
        lambda i: collate_scenes([dataset[i]], engine.cfg.buckets),
        range(len(dataset)), depth=2)
    with open(results_file, "w") as f:
        for i, batch in enumerate(fetcher):
            rows = scene_fn(engine, batch, instance_id=i, rng=rng,
                            max_num_clicks=max_num_clicks, mode=mode, **extra)
            f.write("\n".join(rows) + "\n")
            if i % 10 == 0:
                log(f"[{i + 1}/{len(dataset)}] {batch.scene_names[0]} "
                    f"final IoU {float(rows[-1].split(' ')[4]):.4f}")
    return results_file


def evaluate_dataset_parallel(cfg: Config, model: Agile3D, dataset,
                              results_file: str, *, devices, mode: str = "multi",
                              max_num_clicks: int = 20, seed: int = 42,
                              log=print) -> str:
    """Scene-parallel evaluation: one worker thread per device in
    ``devices``, each with its own engine and its own copy of the weights,
    takes every len(devices)-th scene through the host loop. Scene i's
    clicks are drawn from ``random.Random(seed + i)``, so the rows do not
    depend on the device count; they are written in dataset order."""
    results: dict[int, list[str]] = {}
    lock = threading.Lock()

    def worker(d: int, device):
        engine = InteractiveEngine(cfg, copy.deepcopy(model), device)
        for i in range(d, len(dataset), len(devices)):
            batch = collate_scenes([dataset[i]], cfg.buckets)
            rows = evaluate_scene(engine, batch, instance_id=i,
                                  rng=random.Random(seed + i),
                                  max_num_clicks=max_num_clicks, mode=mode)
            with lock:
                results[i] = rows
            log(f"[dev {d}] scene {i + 1}/{len(dataset)} done")

    with ThreadPoolExecutor(len(devices)) as ex:
        for fu in [ex.submit(worker, d, dev) for d, dev in enumerate(devices)]:
            fu.result()
    with open(results_file, "w") as f:
        for i in range(len(dataset)):
            f.write("\n".join(results[i]) + "\n")
    return results_file
