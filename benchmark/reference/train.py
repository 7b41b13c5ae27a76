"""The reference's training step: the published losses (click-weighted
cross-entropy and soft dice on every decoder round), global-norm clipping
and AdamW, in plain torch with autograd.

Frozen copies, numpy only, of the two host draws a training batch is made
of, so that the reference makes its batches itself from the seeds the
benchmark hands the program: ``augment_coords`` (agile3d_torch/data/
datasets.py @ f6162fe) and ``subsample_objects`` (agile3d_torch/engine/
train.py @ f6162fe).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as rm
from benchmark.reference import sparse as rs


def augment_coords(coords: np.ndarray, rng: np.random.Generator):
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


def subsample_objects(labels_row: np.ndarray, rng: np.random.Generator,
                      max_obj: int = 10):
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


class Batch:
    """A training batch as the reference sees it: the samples' voxels in
    one pyramid (batch ids in the key), features, per-sample rows, labels
    [B, Nmax] (-1 past a sample's voxels) and object counts."""

    def __init__(self, samples, q: float, device, max_obj: int, seed: int):
        """samples: (coords float32 [P, 3] as loaded and augmented, colors
        uint8, labels) per scene."""
        grids, firsts, feats, raws, labs = [], [], [], [], []
        for coords, colors, labels in samples:
            pts = torch.from_numpy(np.ascontiguousarray(coords)).to(device)
            v = rs.voxelize(pts, q)
            grids.append(v.grid)
            raws.append(pts[v.first])
            feats.append(torch.from_numpy(
                np.asarray(colors, np.float32) / 255.0).to(device)[v.first])
            labs.append(np.asarray(labels, np.int32)[v.first.cpu().numpy()])
        counts = [len(g) for g in grids]
        batch = torch.cat([torch.full((c,), i, dtype=torch.long,
                                      device=device)
                           for i, c in enumerate(counts)])
        self.levels = rs.pyramid(torch.cat(grids), batch)
        self.feats = torch.cat(feats)
        self.raw = torch.cat(raws)
        off = np.concatenate([[0], np.cumsum(counts)])
        self.rows = [torch.arange(off[i], off[i + 1], device=device)
                     for i in range(len(counts))]
        n = max(counts)
        rng = np.random.default_rng(seed)
        lab = np.full((len(counts), n), -1, np.int32)
        num_obj = np.zeros(len(counts), np.int64)
        for i, l in enumerate(labs):
            row = np.full(n, -1, np.int32)
            row[:len(l)] = l
            lab[i], num_obj[i] = subsample_objects(row, rng, max_obj)
        self.labels = torch.from_numpy(lab).long().to(device)
        self.num_obj = torch.from_numpy(num_obj).to(device)


def click_weights(raw, valid, click_vox, alpha=0.8, beta=2.0, tita=0.3):
    """alpha + (beta - alpha) * (1 - min(d, tita) / tita), d the distance
    to the nearest click; 0 on pad rows."""
    n = raw.shape[1]
    safe = click_vox.clamp(0, n - 1).long()
    cxyz = torch.gather(raw, 1, safe[..., None].expand(-1, -1, 3))
    d2 = ((raw[:, :, None, :] - cxyz[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where((click_vox >= 0)[:, None, :], d2, float("inf"))
    d = torch.sqrt(d2.amin(-1))
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, tita))
    w = alpha + (beta - alpha) * (1.0 - d.clamp(max=tita) / tita)
    return torch.where(valid, w, torch.zeros_like(w))


def _masked_mean(x, valid):
    return (x * valid).sum(-1) / valid.sum(-1).clamp(min=1)


def losses(rounds, target, weights, valid, bce_coef=1.0, dice_coef=2.0):
    """The weighted sum over every decoder round of the click-weighted
    cross-entropy and the soft dice (the published criterion; its dice
    reduces to a per-point soft accuracy over the object columns)."""
    n_cols = rounds.shape[-1]
    total = 0.0
    for logits in rounds:
        logp = torch.log_softmax(logits, -1)
        ce = -torch.gather(logp, -1, target[..., None])[..., 0]
        bce = _masked_mean(ce * weights, valid).mean()
        p_gt = torch.exp(torch.gather(logp, -1, target[..., None])[..., 0])
        num = 2.0 * p_gt / n_cols
        soft = (num + 1e-6) / (2.0 / n_cols + 1e-6)
        dl = torch.where(num > 1e-6, 1.0 - soft, torch.zeros_like(num))
        dice = _masked_mean(dl * weights, valid).mean()
        total = total + bce_coef * bce + dice_coef * dice
    return total


def forward_loss(w, cfg, batch: Batch, clicks, prec=rm.Precision(),
                 feedback=None, half: bool = False):
    """The supervised step's loss: the backbone in training mode (batch
    statistics), the decoder on the click tables ``clicks`` = (vox, obj,
    time) [B, MC] (``feedback``: the labels its rounds hand on, as
    ``model.decoder`` takes them), the losses. Returns (loss, the labels
    its rounds handed on, the rounds' logits [R, B, N, K]). ``half``: the
    loss of the first half of the batch alone (a planted fault, for the
    limits)."""
    fmap = rm.backbone(w, batch.levels, batch.feats, prec, stats={},
                       checkpoint=True)
    scene = rm.scene_features(w, fmap, batch.rows, batch.raw)
    vox, obj, tim = clicks
    rounds = torch.utils.checkpoint.checkpoint(
        rm.decoder, w, cfg, scene, vox, obj, tim, batch.num_obj, prec,
        feedback, use_reentrant=False)
    valid = scene.valid & (batch.labels >= 0)
    weights = click_weights(scene.raw, valid, vox)
    handed = torch.where(scene.valid, rounds[:-1].detach().argmax(-1), -1)
    if feedback is not None:
        handed = feedback
    b = max(1, len(batch.rows) // 2) if half else len(batch.rows)
    return losses(rounds[:, :b], batch.labels[:b].clamp(min=0), weights[:b],
                  valid[:b]), handed, rounds


class AdamW:
    """optax's clip_by_global_norm(max_norm) then adamw: betas 0.9 /
    0.999, eps 1e-8, decoupled weight decay; a parameter without a
    gradient takes a zero one."""

    def __init__(self, params: dict, lr=1e-4, weight_decay=1e-4,
                 max_norm=0.1):
        self.params = params
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_norm
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Returns the clipped gradients the update used."""
        g = {k: (grads.get(k) if grads.get(k) is not None
                 else torch.zeros_like(p)) for k, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x) for x in g.values()]))
        scale = 1.0 if float(norm) < self.max_norm \
            else self.max_norm / float(norm)
        g = {k: x * scale for k, x in g.items()}
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, p in self.params.items():
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g[k], alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + 1e-8))
        return g
