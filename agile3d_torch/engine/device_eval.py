"""Device-side evaluation rollout (counterpart of the JAX package's
``engine/device_eval.py``), the eval entry point's default.

Per scene, rounds 1..budget run on the device without waiting on the
host: the decoder, the clicked-voxel override, the full-resolution IoU,
the click simulation (boundary distances of the error rows through
``ops/boundary_dist.py``, then the top error cluster picked by
scatter-max) and the click table's extension all stay on the card; the
host reads the rounds' IoUs once, after the loop. Round 0 (``round0_clicks``)
computes its boundary distances on the same kernel, over the scene's rows
already on the card, and reads them back once: the host ranks the
clusters and selects one click per error cluster with the caller's
``random.Random`` shuffle, in the host loop's own code
(``engine/clicks.py::pick_clicks``). Later rounds add at most
one click (the top error cluster; no randomness), so the rows equal the
host loop's (``evaluate_scene``): until the scene converges every round
adds exactly one click, so the host knows each round's click count ahead
and the decoder sees the click table cut to the same bucket as in the host
loop (attention over the same number of clicks, rounded alike).

The loop runs exactly the budget's rounds and calls the decoder in every
one, also after convergence; from the first round with nothing left to
correct on, the rounds add no click and repeat that round's IoU, which is
what the host loop writes without running the model. Both protocols:
``mode="multi"`` (round 0 clicks every object, ``max_num_clicks`` per
object) and ``mode="single"`` (binarised labels, one click in round 0,
``max_num_clicks`` in all, the absolute click count in the CSV).
With the engine's ``sp`` > 1 the rounds run sharded over its ranks
(``parallel/sp_rollout.py``), the full-resolution points split alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from agile3d_torch.data.datasets import SceneBatch
from agile3d_torch.engine.clicks import (
    HostClicks,
    click_column,
    click_override_device,
    click_schedule,
    mean_iou,
    pick_clicks,
)
from agile3d_torch.models.agile3d import ClickState
from agile3d_torch.ops.boundary_dist import boundary_distances_all
from agile3d_torch.parallel.mesh import (
    ONE_RANK,
    Axis,
    all_gather,
    axis_index,
    pmax,
    pmin,
    psum,
)
from agile3d_torch.utils.profiling import annotate


def error_clusters(pred: torch.Tensor, labels: torch.Tensor,
                   coords: torch.Tensor, valid: torch.Tensor,
                   max_label: int, axis: Axis = ONE_RANK):
    """The error analysis of a batch of predictions: pred, labels [B, N]
    (labels in [0, max_label]), coords [B, N, 3], valid [B, N]. Returns
    (err [B, N], compact [B, N] = labels * k + pred, d [B, N] = boundary
    distance on error rows and -inf elsewhere, sizes [B, k * k] = each
    (gt, pred) cluster's largest distance, -inf where the cluster is empty
    or its distance is not finite), k = max_label + 1. The rows come in
    the order ``build_pyramid`` enforces (sorted by packed key): the
    distance kernel's culling relies on it, and rows in another order give
    the same values at many times the cost.

    Over an ``sp`` axis of several ranks, pred and labels are this rank's
    rows [B, Nl] (rows ``[r Nl, (r + 1) Nl)`` of the scene) and coords and
    valid the whole scene's; the outputs are this rank's rows, the sizes
    reduced over the ranks. The kernel reads every rank's clusters (one
    all-gather) and computes this rank's error rows: the rows stay sorted,
    so the culling holds and the bits are the one-process ones."""
    k = max_label + 1
    n_slots = k * k
    nl = pred.shape[1]
    lo = axis_index(axis) * nl
    err = valid[:, lo:lo + nl] & (pred != labels)
    compact = labels * k + pred
    cluster = torch.where(err, compact, -1).to(torch.int32)
    cluster_g = all_gather(cluster.T, axis).T
    query = F.pad(err, (lo, valid.shape[1] - lo - nl))
    # the kernel computes the query rows only (+inf elsewhere): no other
    # row's distance is read
    d = boundary_distances_all(coords.contiguous(), cluster_g.contiguous(),
                               valid.contiguous(), query=query)
    d = d[:, lo:lo + nl]
    neg_inf = torch.full((), float("-inf"), device=d.device)
    d = torch.where(err, d, neg_inf)
    segment = torch.where(err, compact, n_slots).long()
    sizes = torch.full((pred.shape[0], n_slots + 1), float("-inf"),
                       device=d.device).scatter_reduce(
        1, segment, d, "amax")[:, :n_slots]
    # max is exact in any order
    sizes = pmax(torch.where(torch.isfinite(sizes), sizes, neg_inf), axis)
    return err, compact, d, sizes


def reference_keys(max_label: int, device) -> torch.Tensor:
    """The reference's cluster order: ascending 96 gt + 11 pred over the
    compact slots (its unique() order)."""
    k = max_label + 1
    slot = torch.arange(k * k, device=device)
    return (slot // k) * 96 + (slot % k) * 11


@torch.no_grad()
def simulate_click_device(pred: torch.Tensor, labels: torch.Tensor,
                          coords: torch.Tensor, valid: torch.Tensor, *,
                          max_label: int = 10, axis: Axis = ONE_RANK):
    """The click of an eval round >= 1 for one scene: the top error cluster
    by largest boundary distance (ties by the reference's order), its
    first row attaining that distance. pred, labels [N], coords [N, 3],
    valid [N]. Returns (vox, obj, has_error) as device scalars. Over an
    ``sp`` axis, pred and labels are this rank's rows and coords and valid
    the whole scene's (``error_clusters``); the click is a ``pmax`` of the
    distance, then a ``pmin`` of the first global row attaining it (the
    one-process tie-break), the same on every rank."""
    with annotate("agile3d.engine.clicks"):
        err, compact, d, sizes = error_clusters(
            pred[None], labels[None], coords[None], valid[None], max_label,
            axis)
        err, compact, d, sizes = err[0], compact[0], d[0], sizes[0]
        big = torch.iinfo(torch.int64).max
        best = torch.argmin(torch.where(
            sizes == sizes.max(), reference_keys(max_label, d.device), big))
        score = torch.where(err & (compact == best), d,
                            torch.full((), float("-inf"), device=d.device))
        nl, n = pred.shape[0], valid.shape[0]
        lo = axis_index(axis) * nl
        rows = lo + torch.arange(nl, device=d.device)
        vox = pmin(torch.where(score == pmax(score.max(), axis), rows,
                               n).min(), axis)
        mine = (vox >= lo) & (vox < lo + nl)
        obj = psum(torch.where(mine, labels[(vox - lo).clamp(0, nl - 1)], 0),
                   axis)
        has_error = psum(err.any().to(torch.int32), axis) > 0
        return vox.to(torch.int32), obj.to(torch.int32), has_error


@torch.no_grad()
def round0_clicks(coords: torch.Tensor, valid: torch.Tensor,
                  labels: torch.Tensor, labels_host: np.ndarray, *,
                  num_obj: int, rng, max_label: int = 10):
    """Round 0's clicks of the eval protocol, on the zero prediction: every
    object row is an error row, in its object's cluster. coords [N, 3],
    valid [N] and labels [N] (-1 on pad rows) are the scene's rows on the
    device, sorted as ``build_pyramid`` leaves them (the kernel's culling
    relies on it); labels_host [n] the first n rows' labels, the valid
    ones. The distances of the object rows run on
    ``ops/boundary_dist.py``'s kernel and are read back once; the ranking
    and the ``rng`` shuffle are ``pick_clicks``'s, so the clicks are
    ``simulate_clicks``'s on the plain distance. None when the scene has
    no object row."""
    with annotate("agile3d.engine.clicks"):
        err = labels_host != 0
        err_rows = np.nonzero(err)[0].astype(np.int32)
        if not len(err_rows):
            return None
        k = max_label + 1
        rows = torch.from_numpy(err_rows).to(coords.device).long()
        query = valid & (labels != 0)
        cluster = torch.where(query, labels * k, -1).to(torch.int32)
        d = boundary_distances_all(coords[None].contiguous(), cluster[None],
                                   valid[None], query=query[None])
        d = d[0, rows].cpu().numpy()
        cluster_host = np.where(err, labels_host * k, -1)
        return pick_clicks(d, err_rows, cluster_host, labels_host,
                           num_obj=num_obj, training=False,
                           current_num_clicks=0, rng=rng,
                           max_label=max_label)


@torch.no_grad()
def rollout_rounds(model, scene, vox: torch.Tensor, obj: torch.Tensor,
                   tim: torch.Tensor, count: torch.Tensor,
                   num_obj: torch.Tensor, labels: torch.Tensor,
                   labels_full: torch.Tensor, inverse_map: torch.Tensor,
                   buckets: list[int], max_label: int,
                   axis: Axis = ONE_RANK,
                   full_valid: torch.Tensor | None = None) -> torch.Tensor:
    """One click round of one scene on the device for each entry of
    ``buckets``: the click-table width the decoder sees in that round. vox,
    obj, tim [MC]: the click table after round 0, with ``count`` (a device
    scalar) clicks; num_obj [1]; labels [N] (-1 on pad rows); labels_full
    and inverse_map [Nf]. Returns each round's mean IoU, [rounds] on the
    device; nothing in the loop waits on the host.

    Over an ``sp`` axis of several ranks (``parallel/sp_rollout.py``):
    scene and labels are this rank's rows, labels_full, inverse_map (into
    the scene's rows) and full_valid its part of the full-resolution
    points; the decoder is ``parallel/sp.py::forward_mask_local``, the IoU
    and the click reduce over the ranks, and the click table stays the
    same on every rank (each makes the same update from reduced values)."""
    with annotate("agile3d.engine.rollout"):
        nl = labels.shape[0]
        lo = axis_index(axis) * nl
        vox_valid = scene.vox_valid[0] & (labels >= 0)
        target = labels.clamp(min=0)
        # the whole scene's coordinates and validity, gathered once
        coords = all_gather(scene.raw[0].contiguous(), axis)
        valid = all_gather(vox_valid, axis)
        if axis.size == 1:
            decode = lambda cs: model.forward_mask(scene, cs, num_obj)[
                "pred_masks"]
        else:
            from agile3d_torch.parallel.sp import forward_mask_local

            decode = lambda cs: forward_mask_local(model, scene, cs, num_obj,
                                                   axis)[-1]
        mc = vox.shape[0]
        done = torch.zeros((), dtype=torch.bool, device=vox.device)
        iou = None
        ious = []
        for width in buckets:
            with annotate("agile3d.engine.round"):
                pred = decode(ClickState(vox[None, :width], obj[None, :width],
                                         tim[None, :width]))
                pred = pred[0].argmax(-1).to(torch.int32)
                # the clicks on this rank's rows
                mine = vox[:width] - lo
                mine = torch.where((mine >= 0) & (mine < nl), mine, -1)
                pred = click_override_device(pred, mine, obj[:width])
                new_iou = mean_iou(all_gather(pred, axis)[inverse_map],
                                   labels_full, max_label, full_valid, axis)
                iou = new_iou if iou is None else torch.where(done, iou,
                                                              new_iou)
                ious.append(iou)

                new_vox, new_obj, has_err = simulate_click_device(
                    pred, target, coords, valid, max_label=max_label,
                    axis=axis)
                has_err = has_err & ~done
                done = ~has_err  # converged: no later round adds a click
                slot = count.clamp(0, mc - 1).long().reshape(1)
                vox = torch.where(has_err, vox.index_put((slot,), new_vox),
                                  vox)
                obj = torch.where(has_err, obj.index_put((slot,), new_obj),
                                  obj)
                tim = torch.where(has_err, tim.index_put((slot,), count),
                                  tim)
                count = count + has_err.to(count.dtype)
        return torch.stack(ious)


def evaluate_scene_device(engine, batch: SceneBatch, *, instance_id: int,
                          rng, max_num_clicks: int = 20,
                          mode: str = "multi") -> list[str]:
    """``engine/eval.py::evaluate_scene`` with round 0's distances and
    rounds >= 1 on the device: the same CSV rows ``id scene obj clicks
    iou``."""
    with annotate("agile3d.engine.scene"):
        if len(batch.scene_names) != 1:
            raise ValueError("eval runs one scene per batch")
        cfg = engine.cfg
        dev = engine.device
        max_label = cfg.model.max_fg_objects
        scene = engine.run_backbone(batch)

        n = batch.sample_idx.shape[1]
        n_valid = int((batch.sample_idx[0] >= 0).sum())
        labels_v = batch.labels[0, :n_valid]
        num_obj = int(batch.num_obj[0])
        tag = batch.obj_tags[0]
        scene_name = batch.scene_names[0].replace("scene", "")

        with annotate("agile3d.engine.round0"):
            # round 0: zero prediction, one click per error cluster
            clicks = HostClicks(cfg.model.max_clicks)
            pred0 = np.zeros(n_valid, np.int32)
            iou0 = engine.scene_iou(pred0, batch.inverse_map[0],
                                    batch.labels_full[0])
            rows = [f"{instance_id} {scene_name} {tag} "
                    f"{click_column(mode, 0, num_obj)} {iou0}"]
            labels_pad = np.full(n, -1, np.int32)
            labels_pad[:n_valid] = labels_v
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            labels_dev = t(labels_pad)
            coords, vox_valid = scene.raw[0], scene.vox_valid[0]
            if engine.sp_backbone:
                # this rank's rows: the whole scene's, gathered
                axis = engine.sp_mesh["sp"]
                coords = all_gather(coords.contiguous(), axis)
                vox_valid = all_gather(vox_valid, axis)
            new = round0_clicks(coords, vox_valid & (labels_dev >= 0),
                                labels_dev, labels_v, num_obj=num_obj,
                                rng=rng, max_label=max_label)
            if new is not None:
                clicks.extend(new)

            budget, first = click_schedule(mode, num_obj, max_num_clicks)
            rounds = budget - first + 1
            # round r's decoder sees the clicks of round 0 and one more per
            # round before it (until convergence, after which the IoU is
            # held): the host loop's bucket of that count; the table holds
            # every click they add
            buckets = [engine._click_bucket(clicks.count + r)
                       for r in range(rounds)]
            mc = engine._click_bucket(clicks.count + rounds)
            table = (t(clicks.vox[:mc]), t(clicks.obj[:mc]),
                     t(clicks.time[:mc]),
                     torch.tensor(clicks.count, dtype=torch.int32,
                                  device=dev),
                     torch.tensor([num_obj], dtype=torch.int32, device=dev))
            labels_full = t(batch.labels_full[0])
            inverse_map = t(batch.inverse_map[0].astype(np.int64))
        if engine.sp > 1:
            from agile3d_torch.parallel.sp_rollout import rollout_rounds_sp

            ious = rollout_rounds_sp(engine.model, engine.sp_scene(scene),
                                     *table, labels_dev, labels_full,
                                     inverse_map, buckets, max_label,
                                     engine.sp_mesh["sp"])
        else:
            ious = rollout_rounds(engine.model, scene, *table, labels_dev,
                                  labels_full, inverse_map, buckets, max_label)
        with annotate("agile3d.engine.wait"):
            ious = ious.cpu().tolist()
        for r, iou in enumerate(ious):
            rows.append(f"{instance_id} {scene_name} {tag} "
                        f"{click_column(mode, first + r, num_obj)} {iou}")
        return rows
