"""Simulated clicks: error-region analysis and click sampling (counterpart of
the JAX package's ``engine/clicks.py``).

  * Error clusters partition mispredicted points by (gt, pred) pair.
  * For every error point, its distance to the error boundary is the
    distance to the nearest valid point of a DIFFERENT cluster (correct
    points count as cluster -1). That O(E*N) part runs in plain torch on
    the scene's device (the host loops' independent distance; the device
    rollouts call ``ops/boundary_dist.py``'s kernel); the cluster ranking
    (``pick_clicks``) runs on the host.
  * Cluster size = max distance; the next click is the point attaining it
    (first index on ties). Eval keeps all clusters at round 0 and the top
    one afterwards; the chosen clusters are shuffled with the caller's
    ``random.Random`` for click order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agile3d_torch.parallel.mesh import ONE_RANK, Axis, psum
from agile3d_torch.utils.profiling import annotate

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
    wrong. The boundary distances run on ``device``, the ranking on the
    host (``pick_clicks``)."""
    with annotate("agile3d.engine.clicks"):
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
        return pick_clicks(d, err_rows, cluster, labels, num_obj=num_obj,
                           training=training,
                           current_num_clicks=current_num_clicks, rng=rng,
                           max_label=max_label)


def pick_clicks(d: np.ndarray, err_rows: np.ndarray, cluster: np.ndarray,
                labels: np.ndarray, *, num_obj: int, training: bool,
                current_num_clicks: int, rng,
                max_label: int = 10) -> NewClicks:
    """The clicks of a round from its error rows' boundary distances: d
    [E] the distance of each row of err_rows [E] (+inf where no row of
    another cluster is valid); cluster [N] each row's compact (gt, pred)
    id, -1 where right; labels [N]. Clusters rank by their largest
    distance, ties in the reference's unique() order; training keeps the
    top ``num_obj``, eval every cluster in round 0 and the top one after;
    ``rng`` (a ``random.Random``) shuffles them into the click order, and
    each click is the first row attaining its cluster's distance."""
    k = max_label + 1
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


def click_override_device(pred: torch.Tensor, vox: torch.Tensor,
                          obj: torch.Tensor) -> torch.Tensor:
    """Clicked voxels forced to their object id on the device: a scatter-max
    of ``obj + 1`` at the clicked voxels, then the prediction replaced
    there, so the LARGEST object id wins where two clicks share a voxel.
    pred [N] with vox / obj [MC], or pred [B, N] with vox / obj [B, MC];
    slots with vox == -1 are ignored."""
    n = pred.shape[-1]
    tagged = torch.where(vox >= 0, obj.to(torch.int32) + 1, 0)
    tag = torch.zeros(pred.shape, dtype=torch.int32, device=pred.device)
    tag.scatter_reduce_(-1, vox.clamp(0, n - 1).long(), tagged, "amax")
    return torch.where(tag > 0, tag - 1, pred.to(torch.int32))


def iou_per_object(pred: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, max_obj: int = 10,
                   axis: Axis = ONE_RANK):
    """IoU per object id 1..max_obj as float32 [max_obj], and whether each
    object is present in ``labels``; absent objects report 0. Over an axis
    of several ranks, each holding some of the points, the integer counts
    are summed over its ranks (exact, so every rank gets the one-process
    values)."""
    o = torch.arange(1, max_obj + 1, device=pred.device)[:, None]
    p = (pred[None] == o) & valid
    g = (labels[None] == o) & valid
    inter, pc, gc = psum(torch.stack([(p & g).sum(-1), p.sum(-1),
                                      g.sum(-1)]), axis)
    union = pc + gc - inter
    return inter.float() / torch.clamp(union, min=1).float(), gc > 0


def mean_iou(pred: torch.Tensor, labels: torch.Tensor, max_obj: int = 10,
             valid: torch.Tensor | None = None,
             axis: Axis = ONE_RANK) -> torch.Tensor:
    """Mean IoU over the objects present in ``labels`` (a device scalar):
    the scene's metric, on full-resolution labels (those where ``valid``,
    all by default; over ``axis``, see ``iou_per_object``)."""
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    ious, present = iou_per_object(pred, labels, valid, max_obj, axis)
    return torch.where(present, ious, torch.zeros_like(ious)).sum() \
        / torch.clamp(present.sum(), min=1)


def click_schedule(mode: str, num_obj: int, max_num_clicks: int):
    """(budget, first): the last round's click count and the count after
    round 0 (one click per object in the multi-object protocol, one in the
    single-object one)."""
    if mode == "multi":
        return num_obj * max_num_clicks, num_obj
    if mode == "single":
        return max_num_clicks, 1
    raise ValueError(f"eval mode {mode!r}: 'multi' or 'single'")


def click_column(mode: str, current: int, num_obj: int):
    """The CSV's clicks column: per object (multi), absolute (single)."""
    return current / num_obj if mode == "multi" else current
