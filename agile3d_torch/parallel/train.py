"""Data-parallel training over the mesh's ``dp`` axis (counterpart of the
JAX package's ``parallel/train.py``).

Each dp rank holds a replica of the model and collates its own group of
scenes into its own flat pyramid (scenes never mix across ranks). Per step
every rank rolls out its clicks on the device (``engine/device_train.py``)
and takes the supervised forward and backward on its group; then the
gradients are summed over the dp group with an explicit all-reduce (not
``DistributedDataParallel``: the reduction is weighted, BatchNorm's
statistics are averaged rather than taken from rank 0, and a parameter
without a gradient takes zeros). What the step computes is the JAX
package's:

  * the loss is the ``shard_w``-weighted mean of the ranks' losses, and
    each rank's backward runs on its loss times ``shard_w[r] / sum
    shard_w``, so the summed gradient is that of the weighted mean; the
    optimizer (``engine/train.py::Optimizer``) then takes its global norm,
    clips and steps, alike on every rank, and the reported ``gnorm`` is
    the summed gradient's norm;
  * a tail step with fewer scene groups than ranks gives the spare ranks
    group 0 again with weight 0: they contribute nothing, whatever their
    content;
  * BatchNorm's new running statistics are the weighted mean of the
    ranks';
  * the training mIoU weights each sample by ``shard_w[r] * (num_obj >
    0)``.

Random numbers: every rank draws the same host stream (``np_rng``,
``py_rng``) in the JAX package's order; a rank's rollout and dropout
generators are seeded from the drawn seed and the rank, and its groups'
object subsets from the step's seed and the group's index. Each rank loads
only its own scenes, so a training dataset's augmentation generator runs
per rank.
"""

from __future__ import annotations

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import SceneBatch, collate_scenes
from agile3d_torch.data.prefetch import BatchPrefetcher
from agile3d_torch.engine.device_train import train_rollout
from agile3d_torch.engine.train import (
    _per_sample_iou,
    device_click_state,
    subsample_objects,
    supervised_forward,
)
from agile3d_torch.models.agile3d import ClickState
from agile3d_torch.models.backbone import commit_bn_stats
from agile3d_torch.models.criterion import loss_weight_dict, model_num_aux_rounds
from agile3d_torch.parallel.mesh import axis_index, psum
from agile3d_torch.utils.misc import MetricLogger


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed of ``rank``'s own, derived from a drawn seed."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def collate_sharded(dataset, id_groups: list, rank: int, buckets):
    """This rank's group of scene ids loaded and collated into its own flat
    pyramid. Returns (batch, the group's index, its weight): group
    ``rank``, or on a rank past the step's groups group 0 again with weight
    0 (for shape only)."""
    g = rank if rank < len(id_groups) else 0
    batch = collate_scenes([dataset[j] for j in id_groups[g]], buckets)
    return batch, g, float(rank < len(id_groups))


def prepare_dp_step(dataset, ids, d: int, bs: int, cfg: Config, seed: int,
                    rank: int):
    """Host assembly of one dp step on ``rank`` (the prefetchable unit):
    the step's scene ids split into ``d`` groups of ``bs``, this rank's
    group collated (``collate_sharded``), and its samples' object subsets
    drawn from a generator seeded by (``seed``, group). Returns (batch,
    labels, num_obj, shard_w [d])."""
    groups = [[int(j) for j in ids[g * bs:(g + 1) * bs]] for g in range(d)]
    groups = [g for g in groups if g]
    shard_w = np.zeros(d, np.float32)
    shard_w[:len(groups)] = 1.0
    batch, g, _ = collate_sharded(dataset, groups, rank, cfg.buckets)
    rng = np.random.default_rng([seed, g])
    labels = batch.labels.copy()
    num_obj = np.zeros(len(groups[g]), np.int32)
    for i in range(len(num_obj)):
        labels[i], num_obj[i] = subsample_objects(batch.labels[i], rng,
                                                  cfg.model.max_fg_objects)
    return batch, labels, num_obj, shard_w


def make_dp_train_step(cfg: Config, model, optimizer, mesh):
    """The synchronized supervised step of this rank (the one-process
    step's forward, ``engine/train.py::supervised_forward``, then the
    reductions over the dp group):
    ``train_step(device_batch, clicks, labels, num_obj, shard_w,
    dropout_gen=None)`` with this rank's batch on its device and the
    step's ``shard_w`` [D]. Returns the one-process step's dict, every
    number reduced over the dp group (the same on every rank)."""
    axis = mesh["dp"]
    wd = loss_weight_dict(cfg.loss,
                          num_aux_rounds=model_num_aux_rounds(cfg.model))

    def train_step(device_batch, clicks: ClickState, labels: torch.Tensor,
                   num_obj: torch.Tensor, shard_w,
                   dropout_gen: torch.Generator | None = None) -> dict:
        w = float(shard_w[axis_index(axis)])
        wsum = max(float(np.sum(shard_w)), 1e-8)
        optimizer.zero_grad()
        bn_stats = {}
        with torch.enable_grad():
            out, target, vox_valid, losses, tot = supervised_forward(
                cfg, model, wd, device_batch, clicks, labels, num_obj,
                dropout_gen, bn_stats)
            (tot * (w / wsum)).backward()
        with torch.no_grad():
            params = optimizer.params
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            flat = psum(torch.cat([g.reshape(-1) for g in grads]), axis)
            for p, g in zip(params, flat.split([g.numel() for g in grads])):
                p.grad = g.view_as(p).clone()
        gnorm = optimizer.step()
        with torch.no_grad():
            stats = [t for pair in bn_stats.values() for t in pair]
            if stats:
                mean = psum(torch.cat([t.reshape(-1) * w for t in stats]),
                            axis) / wsum
                parts = iter(mean.split([t.numel() for t in stats]))
                commit_bn_stats({s: (next(parts).view_as(m),
                                     next(parts).view_as(v))
                                 for s, (m, v) in bn_stats.items()})
            named = {"loss": tot.detach(),
                     **{k: v.detach() for k, v in losses.items()}}
            keys = list(named)
            red = psum(torch.stack([named[k].float() * w for k in keys]),
                       axis) / wsum
            named = dict(zip(keys, red))
            pred = out["pred_masks"].argmax(-1)
            iou = _per_sample_iou(pred, target, vox_valid, num_obj,
                                  cfg.model.max_fg_objects)
            row_w = w * (num_obj > 0).float()
            num, den = psum(torch.stack([(row_w * iou).sum(), row_w.sum()]),
                            axis)
            miou = num / torch.clamp(den, min=1e-8)
        return {"loss": named.pop("loss"), "losses": named, "gnorm": gnorm,
                "miou": miou, "attn_chunk": out["attn_chunk"]}

    return train_step


def make_dp_rollout(cfg: Config, mesh):
    """``rollout(engine, batch, labels, num_obj, num_iters, seed)`` -> the
    click table for this rank's supervised step: its backbone in training
    mode without gradients, then ``num_iters`` + 1 rounds of the device
    training rollout, its generator seeded from (``seed``, rank)."""
    rank = axis_index(mesh["dp"])
    max_label = cfg.model.max_fg_objects

    def rollout(engine, batch: SceneBatch, labels: torch.Tensor,
                num_obj: torch.Tensor, num_iters: int, seed: int):
        scene = engine.run_backbone(batch, training=True)
        gen = torch.Generator(device=engine.device).manual_seed(
            rank_seed(seed, rank))
        cs, counts = train_rollout(
            engine.model, scene, labels, num_obj, num_iters, gen,
            engine._click_bucket((num_iters + 1) * max_label), max_label)
        return device_click_state(cs, counts, cfg.model.max_clicks)

    return rollout


def dp_train_one_epoch(cfg: Config, mesh, engine, train_step, dataset,
                       epoch: int, *, np_rng: np.random.Generator, py_rng,
                       log=print, print_freq: int = 10,
                       order: np.ndarray | None = None) -> dict:
    """One data-parallel epoch on this rank, ``engine/train.py::
    train_one_epoch``'s counterpart: steps of ``batch_size x num_dp``
    scenes, the order and the steps' seeds drawn from ``np_rng`` before
    the first, each rank's group assembled ``cfg.train.prefetch`` ahead on
    a host thread, the rollout on the device, weight-masked tail steps.
    Returns the epoch's averages, the same on every rank (each logs the
    reduced numbers)."""
    d = mesh.shape["dp"]
    rank = axis_index(mesh["dp"])
    bs = cfg.train.batch_size
    n = len(dataset)
    if order is None:
        order = np_rng.permutation(n)
    span = bs * d
    steps = [order[i: i + span] for i in range(0, n, span)]
    seeds = np_rng.integers(2 ** 31, size=len(steps))
    fetcher = BatchPrefetcher(
        lambda w: prepare_dp_step(dataset, w[0], d, bs, cfg, w[1], rank),
        [(ids, int(s)) for ids, s in zip(steps, seeds)],
        depth=cfg.train.prefetch)
    rollout = make_dp_rollout(cfg, mesh)
    logger = MetricLogger(log=log)
    dev = engine.device
    for batch, labels, num_obj, shard_w in logger.log_every(
            fetcher, print_freq, f"Epoch: [{epoch}] dp"):
        labels_dev = torch.from_numpy(labels).to(dev)
        num_obj_dev = torch.from_numpy(num_obj).to(dev)
        num_iters = py_rng.randint(0, 19)
        clicks = rollout(engine, batch, labels_dev, num_obj_dev, num_iters,
                         int(np_rng.integers(2 ** 31)))
        dropout_gen = None
        if cfg.model.dropout > 0:
            dropout_gen = torch.Generator(device=dev).manual_seed(
                rank_seed(int(np_rng.integers(2 ** 31)), rank))
        out = train_step(engine.device_batch(batch), clicks, labels_dev,
                         num_obj_dev, shard_w, dropout_gen)
        tot = float(out["loss"])
        if not np.isfinite(tot):
            raise FloatingPointError(f"Loss is {tot}, stopping training")
        logger.update(loss=tot, grad_norm=float(out["gnorm"]),
                      mIoU=float(out["miou"]),
                      **{k: float(v) for k, v in out["losses"].items()
                         if k in ("loss_bce", "loss_dice")})
    logger.synchronize_between_processes()
    log(f"Averaged stats: {logger}")
    return {k: m.global_avg for k, m in logger.meters.items()}
