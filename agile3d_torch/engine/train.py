"""Training engine: the iterative-click training loop (counterpart of the
JAX package's ``engine/train.py``, host-rollout path).

Per batch:
  1. collate the scenes; per sample draw a random object subset (1..10
     objects) and remap the labels (``prepare_batch``, seeded per batch);
  2. run the backbone once in training mode without gradients and roll out
     a random number (0..19) of simulated-click rounds (``rollout_clicks``
     on the host, or ``engine/device_train.py::train_rollout`` on the
     device);
  3. one supervised step with gradients through the decoder and the
     backbone: click-weighted CE + dice + aux losses, global-norm clipping,
     AdamW (``make_train_step``), and the BatchNorm running statistics of
     that forward committed once.

Batch assembly (step 1) runs on a host thread ahead of the device step
(``data/prefetch.py``, depth ``cfg.train.prefetch``); the seeds are drawn
before the first batch, so the trajectory is the same at every depth.
"""

from __future__ import annotations

import random as pyrandom

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import collate_scenes
from agile3d_torch.data.prefetch import BatchPrefetcher
from agile3d_torch.engine.clicks import HostClicks, simulate_clicks
from agile3d_torch.engine.device_train import train_rollout
from agile3d_torch.engine.eval import InteractiveEngine, stack_clicks
from agile3d_torch.models.agile3d import Agile3D, ClickState
from agile3d_torch.models.backbone import commit_bn_stats
from agile3d_torch.models.criterion import (
    click_loss_weights,
    criterion_forward,
    loss_weight_dict,
    model_num_aux_rounds,
    total_loss,
)
from agile3d_torch.utils.misc import MetricLogger
from agile3d_torch.utils.profiling import annotate


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay))`` over the model's parameters:

      * the schedule is piecewise constant: ``lr`` times ``lr_drop_gamma``
        for every boundary ``lr_drop[i] * steps_per_epoch`` that the update
        count has reached (optax's ``piecewise_constant_schedule``);
      * clipping uses optax's rule: ``g * max_norm / gnorm`` when
        ``gnorm >= max_norm``, else ``g`` unchanged;
      * AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay on every
        parameter; a parameter without a gradient gets a zero one, as
        optax's would be).

    ``params``: (name, parameter) pairs, as ``named_parameters()`` gives
    them, or bare parameters (then named by position). ``state_dict()``
    holds the update count and AdamW's per-parameter state by those
    names."""

    def __init__(self, params, cfg: Config, steps_per_epoch: int):
        t = cfg.train
        named = [p if isinstance(p, tuple) else (str(i), p)
                 for i, p in enumerate(params)]
        named = [(n, p) for n, p in named if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.max_norm = t.clip_max_norm
        self.boundaries = {int(e) * steps_per_epoch: t.lr_drop_gamma
                           for e in t.lr_drop}
        self.base_lr = t.lr
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=t.lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=t.weight_decay)

    def lr(self, count: int) -> float:
        v = self.base_lr
        for b, scale in sorted(self.boundaries.items()):
            if count >= b:
                v *= scale
        return v

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients, take one AdamW step. Returns the global norm
        of the gradients before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        trigger = gnorm < self.max_norm
        for g in grads:
            g.copy_(torch.where(trigger, g, g / gnorm * self.max_norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(self.count)
        self.adamw.step()
        self.count += 1
        return gnorm

    def state_dict(self) -> dict:
        """``{"count": updates taken (the schedule's position), "params":
        {name: {"step", "exp_avg", "exp_avg_sq"}}}``: AdamW's state of each
        parameter that has one (the live tensors, as torch's optimizers
        return them)."""
        return {"count": self.count,
                "params": {n: dict(self.adamw.state[p])
                           for n, p in zip(self.names, self.params)
                           if self.adamw.state[p]}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s content: the count and, by parameter
        name, AdamW's state (copied onto each parameter's device). Every
        parameter of this optimizer must have an entry, or none may (a
        state taken before the first update)."""
        have = sd["params"]
        if have and set(have) != set(self.names):
            missing = sorted(set(self.names) - set(have))
            extra = sorted(set(have) - set(self.names))
            raise KeyError(f"optimizer state does not match the parameters: "
                           f"missing {missing[:3]}, unknown {extra[:3]}")
        self.adamw.state.clear()
        for n, p in zip(self.names, self.params):
            if n not in have:
                continue
            st = have[n]
            for key in ("exp_avg", "exp_avg_sq"):
                if tuple(st[key].shape) != tuple(p.shape):
                    raise ValueError(f"{n}.{key}: shape {tuple(st[key].shape)}"
                                     f" != {tuple(p.shape)}")
            self.adamw.state[p] = {
                "step": torch.tensor(float(st["step"])),
                "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
                "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).clone()}
        self.count = int(sd["count"])


def make_optimizer(model: Agile3D, cfg: Config, steps_per_epoch: int):
    """The optimizer over ``model``'s named parameters and its schedule."""
    opt = Optimizer(model.named_parameters(), cfg, steps_per_epoch)
    return opt, opt.lr


def _per_sample_iou(pred, labels, valid, num_obj, max_obj):
    """Per-sample foreground mean IoU [B] over objects 1..num_obj."""
    ious = []
    for o in range(1, max_obj + 1):
        p = (pred == o) & valid
        g = (labels == o) & valid
        inter = (p & g).sum(-1)
        union = p.sum(-1) + g.sum(-1) - inter
        ious.append(torch.where(union > 0, inter / union.clamp(min=1),
                                torch.zeros((), device=pred.device)))
    ious = torch.stack(ious, -1)                                  # [B, max_obj]
    present = (torch.arange(1, max_obj + 1, device=pred.device)[None, :]
               <= num_obj[:, None])
    return (torch.where(present, ious, torch.zeros_like(ious)).sum(-1)
            / num_obj.clamp(min=1))


def _batch_miou(pred, labels, valid, num_obj, max_obj):
    return _per_sample_iou(pred, labels, valid, num_obj, max_obj).mean()


def supervised_forward(cfg: Config, model: Agile3D, wd: dict, device_batch,
                       clicks: ClickState, labels: torch.Tensor,
                       num_obj: torch.Tensor, dropout_gen, bn_stats: dict):
    """The supervised step's forward, with gradients: the backbone in
    training mode (each BatchNorm's new running statistics land in
    ``bn_stats``), the decoder, the click-weighted losses. Returns (out,
    target, vox_valid, losses, total); ``wd`` is ``loss_weight_dict``'s."""
    pyr, feats, raw, sample_idx = device_batch
    scene = model.forward_backbone(pyr, feats, raw, sample_idx, bn_stats)
    out = model.forward_mask(scene, clicks, num_obj, train_gen=dropout_gen)
    target = labels.clamp(min=0)
    vox_valid = scene.vox_valid & (labels >= 0)
    weights = click_loss_weights(scene.raw, vox_valid, clicks.vox,
                                 clicks.vox >= 0, cfg.loss)
    losses = criterion_forward(out["all_masks"], target, weights, vox_valid,
                               cfg.loss)
    return out, target, vox_valid, losses, total_loss(losses, wd)


def make_train_step(cfg: Config, model: Agile3D, optimizer: Optimizer):
    """The supervised step: forward with gradients through the decoder and
    the backbone (training-mode BatchNorm), losses, backward, clipped
    AdamW step, and the forward's BatchNorm statistics committed."""
    wd = loss_weight_dict(cfg.loss,
                          num_aux_rounds=model_num_aux_rounds(cfg.model))

    def train_step(device_batch, clicks: ClickState, labels: torch.Tensor,
                   num_obj: torch.Tensor,
                   dropout_gen: torch.Generator | None = None) -> dict:
        """``dropout_gen`` draws the decoder's dropout masks (``cfg.model.
        dropout`` > 0); None runs without dropout."""
        optimizer.zero_grad()
        bn_stats = {}
        with torch.enable_grad():
            out, target, vox_valid, losses, tot = supervised_forward(
                cfg, model, wd, device_batch, clicks, labels, num_obj,
                dropout_gen, bn_stats)
            tot.backward()
        gnorm = optimizer.step()
        commit_bn_stats(bn_stats)
        with torch.no_grad():
            pred = out["pred_masks"].argmax(-1)
            miou = _batch_miou(pred, target, vox_valid, num_obj,
                               cfg.model.max_fg_objects)
        return {"loss": tot.detach(),
                "losses": {k: v.detach() for k, v in losses.items()},
                "gnorm": gnorm, "miou": miou, "attn_chunk": out["attn_chunk"]}

    return train_step


def subsample_objects(labels_row: np.ndarray, rng: np.random.Generator,
                      max_obj: int = 10):
    """A random object subset and the label remap; labels_row uses -1 for
    pad slots. Only -1 is excluded from the candidates, so the background
    region (label 0) can be drawn as a foreground object; unselected ids
    fall back to background."""
    valid_ids = np.unique(labels_row)
    valid_ids = valid_ids[valid_ids != -1]
    if len(valid_ids) == 0:
        return np.where(labels_row >= 0, 0, -1).astype(np.int32), 0
    k = rng.integers(1, min(max_obj, len(valid_ids)) + 1)
    chosen = valid_ids[rng.permutation(len(valid_ids))[:k]]
    out = np.where(labels_row >= 0, 0, -1).astype(np.int32)
    for i, obj in enumerate(chosen):
        out[labels_row == obj] = i + 1
    return out, int(k)


def rollout_clicks(engine: InteractiveEngine, scene, labels: np.ndarray,
                   num_obj: np.ndarray, raw_per_sample: list, n_valid: list,
                   rng: pyrandom.Random, cfg: Config) -> list[HostClicks]:
    """The no-gradient rollout before the supervised step: a random number
    of rounds (0..19), each a batched decoder pass and the click simulator
    per sample (clicked voxels forced to their object)."""
    with annotate("agile3d.engine.rollout"):
        b = labels.shape[0]
        clicks = [HostClicks(cfg.model.max_clicks) for _ in range(b)]
        num_iters = rng.randint(0, 19)
        current = 0
        while current <= num_iters:
            with annotate("agile3d.engine.round"):
                if current == 0:
                    preds = [np.zeros(n_valid[i], np.int32) for i in range(b)]
                else:
                    pred_dev = engine.run_mask_batch(scene, clicks, num_obj)
                    with annotate("agile3d.engine.wait"):
                        pred_host = pred_dev.cpu().numpy()
                    preds = []
                    for i in range(b):
                        p = pred_host[i, : n_valid[i]].astype(np.int32)
                        v = clicks[i].vox[: clicks[i].count]
                        p[v] = clicks[i].obj[: clicks[i].count]
                        preds.append(p)
                for i in range(b):
                    new = simulate_clicks(
                        preds[i], labels[i, : n_valid[i]], raw_per_sample[i],
                        num_obj=int(num_obj[i]), training=True,
                        current_num_clicks=current, rng=rng,
                        device=engine.device,
                        max_label=cfg.model.max_fg_objects)
                    if new is not None:
                        clicks[i].extend(new)
                current += 1
        return clicks


def prepare_batch(dataset, batch_ids, cfg: Config, seed: int):
    """Load, quantize and collate the scenes, and draw each sample's
    object subset from a generator of its own seed. Returns (batch,
    labels, num_obj, n_valid)."""
    samples = [dataset[int(j)] for j in batch_ids]
    batch = collate_scenes(samples, cfg.buckets)
    b = len(samples)
    n_valid = [int((batch.sample_idx[i] >= 0).sum()) for i in range(b)]
    rng = np.random.default_rng(seed)
    labels_new = batch.labels.copy()
    num_obj = np.zeros(b, np.int32)
    for i in range(b):
        labels_new[i], num_obj[i] = subsample_objects(
            batch.labels[i], rng, cfg.model.max_fg_objects)
    return batch, labels_new, num_obj, n_valid


def click_state(clicks: list[HostClicks], max_clicks: int, device) -> ClickState:
    """The batch's click tables as a ClickState: 64 slots when every sample
    has at most 64 clicks, else ``max_clicks``."""
    mc = 64 if max(c.count for c in clicks) <= 64 else max_clicks
    return stack_clicks(clicks, mc, device)


def device_click_state(cs: ClickState, counts: torch.Tensor,
                       max_clicks: int) -> ClickState:
    """The device rollout's click table cut or padded (vox -1) to 64 slots
    when every sample has at most 64 clicks, else to ``max_clicks``; it
    stays on the device."""
    with annotate("agile3d.engine.wait"):
        most = int(counts.max())
    mc = 64 if most <= 64 else max_clicks
    b, have = cs.vox.shape
    if have >= mc:
        return ClickState(*(t[:, :mc] for t in cs))
    pad = lambda t, v: torch.cat([t, t.new_full((b, mc - have), v)], dim=1)
    return ClickState(pad(cs.vox, -1), pad(cs.obj, 0), pad(cs.time, 0))


def train_one_epoch(engine: InteractiveEngine, train_step, dataset,
                    cfg: Config, epoch: int, *, np_rng: np.random.Generator,
                    py_rng: pyrandom.Random, order: np.ndarray | None = None,
                    log=print, print_freq: int = 10,
                    device_rollout: bool = False) -> dict:
    """One epoch over ``dataset`` in batches of ``cfg.train.batch_size``
    (the last may be short). The order and every batch's subsample seed
    are drawn from ``np_rng`` before the first batch, and the batches are
    assembled ``cfg.train.prefetch`` ahead on a host thread (0: between
    the steps; the same trajectory). ``device_rollout``
    runs each batch's click rollout on the device: its round count comes
    from ``py_rng`` and its generator's seed from ``np_rng``, drawn where
    the JAX package draws them. With ``cfg.model.dropout`` > 0 the
    supervised step's dropout generator is seeded from ``np_rng`` after
    the rollout, where the JAX package draws its key, so every later draw
    of the epoch stays in step with the JAX package's; the rollout's
    decoder runs without dropout. Logs through a ``MetricLogger`` every
    ``print_freq`` steps and at the last. Returns the epoch's averages
    (loss, grad_norm, mIoU, loss_bce, loss_dice). Raises
    FloatingPointError on a non-finite loss."""
    bs = cfg.train.batch_size
    n = len(dataset)
    if order is None:
        order = np_rng.permutation(n)
    batches = [order[i: i + bs] for i in range(0, n, bs)]
    seeds = np_rng.integers(2 ** 31, size=len(batches))
    fetcher = BatchPrefetcher(
        lambda w: prepare_batch(dataset, w[0], cfg, w[1]),
        [(ids, int(s)) for ids, s in zip(batches, seeds)],
        depth=cfg.train.prefetch)
    logger = MetricLogger(log=log)
    dev = engine.device
    for batch, labels_new, num_obj, n_valid in logger.log_every(
            fetcher, print_freq, f"Epoch: [{epoch}]"):
        b = labels_new.shape[0]

        # rollout, with the backbone normalising as the supervised pass will
        scene = engine.run_backbone(batch, training=True)
        labels_dev = torch.from_numpy(labels_new).to(dev)
        num_obj_dev = torch.from_numpy(num_obj).to(dev)
        if device_rollout:
            num_iters = py_rng.randint(0, 19)
            gen = torch.Generator(device=dev).manual_seed(
                int(np_rng.integers(2 ** 31)))
            max_label = cfg.model.max_fg_objects
            cs, counts = train_rollout(
                engine.model, scene, labels_dev, num_obj_dev, num_iters, gen,
                engine._click_bucket((num_iters + 1) * max_label), max_label)
            clicks = device_click_state(cs, counts, cfg.model.max_clicks)
        else:
            raw_per_sample, off = [], 0
            for i in range(b):
                raw_per_sample.append(batch.raw[off: off + n_valid[i]])
                off += n_valid[i]
            clicks = click_state(
                rollout_clicks(engine, scene, labels_new, num_obj,
                               raw_per_sample, n_valid, py_rng, cfg),
                cfg.model.max_clicks, dev)
        del scene

        dropout_gen = None
        if cfg.model.dropout > 0:
            dropout_gen = torch.Generator(device=dev).manual_seed(
                int(np_rng.integers(2 ** 31)))
        with annotate("agile3d.engine.step"):
            out = train_step(engine.device_batch(batch), clicks, labels_dev,
                             num_obj_dev, dropout_gen)
        with annotate("agile3d.engine.wait"):
            tot = float(out["loss"])
        if not np.isfinite(tot):
            raise FloatingPointError(f"Loss is {tot}, stopping training")
        logger.update(loss=tot, grad_norm=float(out["gnorm"]),
                      mIoU=float(out["miou"]),
                      **{k: float(v) for k, v in out["losses"].items()
                         if k in ("loss_bce", "loss_dice")})
    log(f"Averaged stats: {logger}")
    return {k: m.global_avg for k, m in logger.meters.items()}
