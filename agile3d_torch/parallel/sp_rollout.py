"""The device eval rollout with the voxel axis sharded over the mesh's ``sp``
axis (counterpart of the JAX package's ``parallel/sp_rollout.py``).

Every rank runs the rounds of ``engine/device_eval.py::rollout_rounds`` on
its rows, given the ``sp`` axis; those rounds' cross-rank steps are:

  * the decoder: ``parallel/sp.py::forward_mask_local``;
  * the clicked-voxel override: row-local;
  * the full-resolution IoU: one all-gather of the int32 prediction, a
    row-local gather through this rank's part of the inverse map, and one
    integer ``psum`` of (intersection, |pred|, |gt|) per object -- integer
    sums are exact, so the IoU is the one-process round's bit for bit;
  * the click simulation (``device_eval.py::simulate_click_device``): one
    all-gather of the cluster ids; the boundary distance runs on the
    port's kernel (``ops/boundary_dist.py``) over the gathered columns,
    its query being the error rows of this rank, and the rank keeps its
    rows (a minimum is exact in any order, and the gathered rows stay
    sorted, so the kernel's tile culling still holds: the same bits as the
    one-process round); the cluster ranking is a 121-slot ``pmax``; the
    click is a ``pmax`` of the distance, then a ``pmin`` of the first
    global row that attains it (the one-process tie-break);
  * the click table's extension: every rank makes the same update from
    reduced values, so the table stays the same on every rank.

The coordinates and validity flags are gathered once per scene. This
module splits a scene's per-row and full-resolution inputs over the ranks.
"""

from __future__ import annotations

import torch

from agile3d_torch.engine.device_eval import rollout_rounds
from agile3d_torch.parallel.mesh import Axis, axis_index
from agile3d_torch.parallel.sp import shard_rows


@torch.no_grad()
def rollout_rounds_sp(model, scene_l, vox, obj, tim, count, num_obj,
                      labels, labels_full, inverse_map, buckets: list[int],
                      max_label: int, axis: Axis):
    """``engine/device_eval.py::rollout_rounds`` with this rank's rows (the
    JAX package's ``make_device_rollout_sp``): scene_l holds this rank's
    rows; labels [N] (-1 on pad rows), labels_full and inverse_map [Nf]
    are the whole scene's, and each rank takes its block of them (the
    full-resolution points padded to a multiple of the rank count, the
    padding masked out of the IoU). The click table (vox, obj, tim [MC],
    count) and num_obj [1] are the same on every rank. Returns the rounds'
    mean IoUs, the same on every rank."""
    nf = labels_full.shape[0]
    pad = -nf % axis.size
    part = lambda a: shard_rows(torch.nn.functional.pad(a, (0, pad)), axis, 0)
    nfl = (nf + pad) // axis.size
    full_valid = (axis_index(axis) * nfl
                  + torch.arange(nfl, device=labels.device)) < nf
    return rollout_rounds(model, scene_l, vox, obj, tim, count, num_obj,
                          shard_rows(labels, axis, 0), part(labels_full),
                          part(inverse_map), buckets, max_label, axis,
                          full_valid)
