"""Device-side training rollout (counterpart of the JAX package's
``engine/device_train.py``): the random-length simulated-click warm-up
before each supervised step, with every round on the device.

The host rollout (``engine/train.py::rollout_clicks``) reads each round's
prediction back and simulates the clicks per sample on the host. Here the
decoder, the clicked-voxel override, the multi-cluster error analysis
(training takes the top ``num_obj`` clusters of each sample per round, one
click each) and the click table's extension stay on the card; the click
table feeds the supervised step without leaving it.

Random numbers: the host rollout shuffles the selected clusters with
python's ``random`` (the click order within a round). Here the order is a
ranking of uniform draws from a ``torch.Generator`` seeded by the caller:
the same distribution, another stream (the JAX package's device rollout
uses a JAX key, a third one). Given the same order, the clicks equal the
host rollout's; the order feeds the decoder through the click-time
encoding, so with other draws the later rounds may pick other clicks.
"""

from __future__ import annotations

import torch

from agile3d_torch.engine.clicks import click_override_device
from agile3d_torch.engine.device_eval import error_clusters, reference_keys
from agile3d_torch.models.agile3d import ClickState
from agile3d_torch.utils.profiling import annotate


@torch.no_grad()
def multi_cluster_clicks_device(pred: torch.Tensor, labels: torch.Tensor,
                                coords: torch.Tensor, valid: torch.Tensor,
                                num_obj: torch.Tensor, u: torch.Tensor, *,
                                max_label: int = 10):
    """Training clicks of one round for a batch: per sample the top
    ``num_obj`` error clusters by largest boundary distance (ties by the
    reference's order), one click each at the first row attaining the
    cluster's distance, in the order that ranks ``u`` [B, S] (uniform
    draws). pred, labels [B, N]; coords [B, N, 3]; valid [B, N]; num_obj
    [B]. Returns (vox, obj, rank, sel), each [B, S] with S = max_label
    slots: ``sel`` marks live clicks, ``rank`` is each click's place in the
    round's order among them."""
    with annotate("agile3d.engine.clicks"):
        err, compact, d, sizes = error_clusters(pred, labels, coords, valid,
                                                max_label)
        s_cap = max_label
        # slots by size descending, ties by the reference key ascending
        by_key = torch.argsort(reference_keys(max_label, d.device),
                               stable=True)
        order = by_key[torch.argsort(-sizes[:, by_key], dim=1, stable=True)]
        sel_slots = order[:, :s_cap]                                  # [B, S]
        sel_sizes = torch.gather(sizes, 1, sel_slots)
        slot_ids = torch.arange(s_cap, device=d.device)
        sel = ((slot_ids[None, :] < num_obj[:, None])
               & torch.isfinite(sel_sizes))

        # per selected cluster: the first row attaining its largest distance
        in_sel = (err[:, None, :]
                  & (compact[:, None, :] == sel_slots[..., None])
                  & (d[:, None, :] == sel_sizes[..., None]))      # [B, S, N]
        vox = torch.argmax(in_sel.to(torch.uint8), dim=2)
        obj = torch.gather(labels, 1, vox)

        u = torch.where(sel, u, torch.full((), float("inf"), device=u.device))
        rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1,
                             stable=True)
        return (vox.to(torch.int32), obj.to(torch.int32), rank.to(torch.int32),
                sel)


@torch.no_grad()
def train_rollout(model, scene, labels: torch.Tensor, num_obj: torch.Tensor,
                  num_iters: int, generator: torch.Generator | None, mc: int,
                  max_label: int = 10, order: torch.Tensor | None = None):
    """Rounds 0..num_iters of the training rollout on the device (round 0
    on the zero prediction, as the host rollout). labels [B, N] (-1 on pad
    rows), num_obj [B]; ``mc`` slots in the click table (clicks past it are
    dropped). Each round's clicks are ordered by uniform draws from
    ``generator``, or by ``order`` [B, max_label] in every round where it
    is given (a pinned order). Returns (ClickState [B, mc], counts [B]);
    nothing in the loop waits on the host."""
    with annotate("agile3d.engine.rollout"):
        b, n = labels.shape
        dev = labels.device
        target = labels.clamp(min=0)
        valid = scene.vox_valid & (labels >= 0)
        raw = scene.raw
        rows = torch.arange(b, device=dev)[:, None]
        # one column past the table takes the dropped writes
        vox = torch.full((b, mc + 1), -1, dtype=torch.int32, device=dev)
        obj = torch.zeros((b, mc + 1), dtype=torch.int32, device=dev)
        tim = torch.zeros((b, mc + 1), dtype=torch.int32, device=dev)
        count = torch.zeros(b, dtype=torch.int32, device=dev)
        for current in range(num_iters + 1):
            with annotate("agile3d.engine.round"):
                if current == 0:
                    pred = torch.zeros((b, n), dtype=torch.int32, device=dev)
                else:
                    out = model.forward_mask(
                        scene,
                        ClickState(vox[:, :mc], obj[:, :mc], tim[:, :mc]),
                        num_obj)
                    pred = out["pred_masks"].argmax(-1).to(torch.int32)
                    pred = click_override_device(pred, vox[:, :mc],
                                                 obj[:, :mc])
                u = order if order is not None else torch.rand(
                    (b, max_label), generator=generator, device=dev)
                new_vox, new_obj, rank, sel = multi_cluster_clicks_device(
                    pred, target, raw, valid, num_obj, u, max_label=max_label)
                slots = torch.where(sel, count[:, None] + rank,
                                    mc).clamp(max=mc).long()
                vox[rows, slots] = new_vox
                obj[rows, slots] = new_obj
                tim[rows, slots] = slots.to(torch.int32)
                count = torch.clamp(count + sel.sum(-1, dtype=torch.int32),
                                    max=mc)
        return ClickState(vox[:, :mc], obj[:, :mc], tim[:, :mc]), count
