"""Simulated clicks: error-region analysis and click sampling (counterpart of
the JAX package's ``engine/clicks.py``).

  * Error clusters partition mispredicted points by (gt, pred) pair.
  * For every error point, its distance to the error boundary is the
    distance to the nearest valid point of a DIFFERENT cluster (correct
    points count as cluster -1). That O(E*N) part runs in torch on the
    scene's device; the cluster ranking runs on the host.
  * Cluster size = max distance; the next click is the point attaining it
    (first index on ties). Eval keeps all clusters at round 0 and the top
    one afterwards; the chosen clusters are shuffled with the caller's
    ``random.Random`` for click order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# pair distances computed per chunk of error rows: rows * N <= this
_CHUNK_ELEMS = 1 << 26


@torch.no_grad()
def boundary_distances(coords: torch.Tensor, cluster: torch.Tensor,
                       valid: torch.Tensor, err_idx: torch.Tensor) -> torch.Tensor:
    """d[e] = min over valid j with cluster[j] != cluster[err_idx[e]] of
    ||coords[err_idx[e]] - coords[j]||, in float32 with explicit per-axis
    differences (the |x|^2 - 2xy + |y|^2 form cancels catastrophically).
    coords [N, 3]; cluster [N] (-1 = not an error); valid [N] bool;
    err_idx [E] rows of error points."""
    n = coords.shape[0]
    rows = max(1, min(len(err_idx), _CHUNK_ELEMS // max(n, 1)))
    inf = torch.tensor(float("inf"), dtype=coords.dtype, device=coords.device)
    out = []
    for s in range(0, len(err_idx), rows):
        idx = err_idx[s:s + rows].long()
        ec, cl = coords[idx], cluster[idx]
        d2 = torch.zeros((len(idx), n), dtype=coords.dtype, device=coords.device)
        for ax in range(coords.shape[1]):
            diff = ec[:, ax][:, None] - coords[:, ax][None, :]
            d2 = d2 + diff * diff
        excl = (cl[:, None] == cluster[None, :]) | ~valid[None, :]
        out.append(torch.where(excl, inf, d2).amin(dim=1))
    d2 = torch.cat(out) if out else coords.new_zeros(0)
    return torch.sqrt(torch.clamp(d2, min=0.0))


class NewClicks(NamedTuple):
    vox: np.ndarray    # [n_new] voxel rows
    obj: np.ndarray    # [n_new] gt labels (0 = background click)
    order: np.ndarray  # [n_new] click order within this round


def simulate_clicks(
    pred: np.ndarray,        # [N] int predicted labels (valid rows)
    labels: np.ndarray,      # [N] int gt labels in [0, num_obj]
    coords: np.ndarray,      # [N, 3] raw coords (valid rows)
    *,
    num_obj: int,
    training: bool,
    current_num_clicks: int,
    rng,                     # python random.Random (shuffle semantics)
    device="cuda",
    max_label: int = 10,
) -> NewClicks | None:
    """Next clicks for the current prediction, or None when nothing is
    wrong. The boundary distances run on ``device``."""
    err = pred != labels
    if not err.any():
        return None

    k = max_label + 1
    compact = labels.astype(np.int64) * k + pred.astype(np.int64)
    cluster = np.where(err, compact, -1).astype(np.int32)
    err_rows = np.nonzero(err)[0].astype(np.int32)
    d = boundary_distances(
        torch.as_tensor(np.asarray(coords, np.float32), device=device),
        torch.as_tensor(cluster, device=device),
        torch.ones(len(pred), dtype=torch.bool, device=device),
        torch.as_tensor(err_rows, device=device)).cpu().numpy()

    err_cl = cluster[err_rows]
    # rank clusters by max boundary distance, descending; ties keep the
    # reference's unique() order (ascending 96*gt + 11*pred key)
    uniq = np.unique(err_cl)
    ref_key = (uniq // k) * 96 + (uniq % k) * 11
    uniq = uniq[np.argsort(ref_key, kind="stable")]
    sizes = np.array([d[err_cl == c].max() for c in uniq])
    ranked = uniq[np.argsort(-sizes, kind="stable")]

    if training:
        selected = ranked[:num_obj]
    elif current_num_clicks == 0:
        selected = ranked
    else:
        selected = ranked[:1]
    selected = list(selected)
    rng.shuffle(selected)

    vox, obj, order = [], [], []
    for click_order, c in enumerate(selected):
        rows = err_rows[err_cl == c]
        best = rows[int(np.argmax(d[err_cl == c]))]  # first index on ties
        vox.append(int(best))
        obj.append(int(labels[best]))
        order.append(click_order)
    return NewClicks(np.array(vox, np.int32), np.array(obj, np.int32),
                     np.array(order, np.int32))


class HostClicks:
    """Growable per-sample click table on the host."""

    def __init__(self, max_clicks: int):
        self.max_clicks = max_clicks
        self.vox = np.full(max_clicks, -1, np.int32)
        self.obj = np.zeros(max_clicks, np.int32)
        self.time = np.zeros(max_clicks, np.int32)
        self.count = 0

    def extend(self, new: NewClicks):
        """New click times are offset by the current click count."""
        n = len(new.vox)
        if self.count + n > self.max_clicks:
            raise ValueError(
                f"click budget exceeded: {self.count}+{n} > {self.max_clicks}")
        sl = slice(self.count, self.count + n)
        self.vox[sl] = new.vox
        self.obj[sl] = new.obj
        self.time[sl] = new.order + self.count
        self.count += n


def apply_click_override(pred: np.ndarray, clicks: HostClicks) -> np.ndarray:
    """Clicked voxels are forced to their ground-truth object id."""
    out = pred.copy()
    out[clicks.vox[: clicks.count]] = clicks.obj[: clicks.count]
    return out


def iou_per_object(pred: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, max_obj: int = 10):
    """IoU per object id 1..max_obj as float32 [max_obj], and whether each
    object is present in ``labels``; absent objects report 0."""
    ious, present = [], []
    for o in range(1, max_obj + 1):
        p = (pred == o) & valid
        g = (labels == o) & valid
        inter = (p & g).sum()
        union = p.sum() + g.sum() - inter
        ious.append(inter.float() / torch.clamp(union, min=1).float())
        present.append(g.sum() > 0)
    return torch.stack(ious), torch.stack(present)
