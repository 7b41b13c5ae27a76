"""The reference's view of a scene and the numbers that judge what the
program served: a voxelised scene through the plain backbone, the mask
logits for a click table, and the gaps between the program's answers and
the reference's."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import model as rm
from benchmark.reference import sparse as rs


class RefScene(NamedTuple):
    vox: rs.Voxels
    scene: rm.Scene      # one sample, [1, N, ...]
    labels_full: torch.Tensor   # [P] per point


def min_shift(coords: np.ndarray) -> np.ndarray:
    """The scans' loaders' shift: each axis minus its minimum, in float32."""
    c = np.asarray(coords, np.float32)
    return c - c.min(0, keepdims=True)


@torch.no_grad()
def ref_scene(w: dict, coords, colors, labels, q: float, device,
              prec: rm.Precision = rm.Precision()) -> RefScene:
    """coords float32 [P, 3] (min-shifted), colors uint8 [P, 3], labels."""
    pts = torch.from_numpy(np.ascontiguousarray(coords)).to(device)
    feats = torch.from_numpy(np.asarray(colors, np.float32) / 255.0).to(device)
    vox = rs.voxelize(pts, q)
    lv = rs.pyramid(vox.grid, torch.zeros(len(vox.grid), dtype=torch.long,
                                          device=device))
    fmap = rm.backbone(w, lv, feats[vox.first], prec)
    scene = rm.scene_features(w, fmap, [torch.arange(len(vox.grid),
                                                     device=device)],
                              pts[vox.first])
    return RefScene(vox, scene, torch.from_numpy(
        np.asarray(labels, np.int64)).to(device))


def override(labels: torch.Tensor, vox: torch.Tensor, obj: torch.Tensor):
    """Clicked voxels take their click's object (the largest where two
    clicks share a voxel)."""
    tag = torch.zeros_like(labels)
    tag.scatter_reduce_(0, vox.long(), obj.long() + 1, "amax")
    return torch.where(tag > 0, tag - 1, labels), tag > 0


def mean_iou(pred: torch.Tensor, gt: torch.Tensor, max_obj: int) -> float:
    """Mean IoU over the objects 1..max_obj present in ``gt``."""
    ious = []
    for o in range(1, max_obj + 1):
        g = gt == o
        if not bool(g.any()):
            continue
        p = pred == o
        inter = int((p & g).sum())
        union = int((p | g).sum())
        ious.append(inter / max(union, 1))
    return float(np.mean(ious)) if ious else 0.0


def logit_gap(logits: torch.Tensor, served: torch.Tensor,
              clicked: torch.Tensor, forced: torch.Tensor) -> float:
    """The widest gap by which the served label's logit lies below the
    reference's best, over voxels that no click forces; a forced voxel
    served with another label than its click's counts as an infinite gap.
    logits [N, K]; served, forced [N] labels; clicked [N] bool."""
    k = logits.shape[1]
    bad = (served < 0) | (served >= k)
    got = torch.gather(logits, 1, served.clamp(0, k - 1).long()[:, None])[:, 0]
    gap = logits.max(1).values - got
    gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    free = gap[~clicked]
    worst = float(free.max()) if len(free) else 0.0
    if bool((clicked & (served != forced)).any()):
        return float("inf")
    return worst


class Verdict(NamedTuple):
    logit_err: float    # the rounds' logits against the reference's
    logit_gap: float    # the served labels under the reference's logits
    iou: float          # the reference's IoU of the pass
    labels: torch.Tensor  # the reference's last labels, clicks forced [N]


@torch.no_grad()
def judge_pass(w, cfg, ref: RefScene, vox, obj, tim, num_obj, rounds,
               served_full=None) -> Verdict:
    """One decoder pass of another computation (the program, or a control
    in its place) judged by the reference, which follows its rounds: each
    round of the reference takes the labels that the other's round before
    it handed on (``model.decoder``'s ``feedback``). vox / obj / tim [MC]
    the pass's click table (-1 = unused), ``rounds`` [R, N, K] the pass's
    logits of every round on the scene's voxels. ``logit_err``: the
    largest difference of a logit, over the largest reference logit, of
    any round (object columns in use). ``logit_gap``: the widest gap by
    which a served point's label lies below the reference's best, on the
    last round (``served_full`` per point; else the argmax of the last
    round with the clicks' override). The IoU: of the reference's labels
    with the override, over the points."""
    k = rounds.shape[-1]
    valid = ref.scene.valid[0]
    feedback = torch.where(valid, rounds[:-1].argmax(-1), -1)[:, None]
    mine = rm.decoder(w, cfg, ref.scene, vox[None], obj[None], tim[None],
                      num_obj, feedback=feedback)[:, 0]
    cols = torch.arange(k, device=mine.device) <= int(num_obj[0])
    err = float((mine - rounds)[..., cols].abs().max()
                / mine[..., cols].abs().max().clamp(min=1e-30))
    live = vox >= 0
    forced, clicked = override(mine[-1].argmax(1), vox[live], obj[live])
    inv = ref.vox.inverse
    if served_full is None:
        served_full = override(rounds[-1].argmax(1), vox[live],
                               obj[live])[0][inv]
    gap = logit_gap(mine[-1][inv], served_full, clicked[inv], forced[inv])
    max_obj = cfg["decoder"]["max_fg_objects"]
    return Verdict(err, gap, mean_iou(forced[inv], ref.labels_full, max_obj),
                   forced)
