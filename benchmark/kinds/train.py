"""Traffic kind ``train``: ``engine/train.py::train_one_epoch`` as ``python
-m agile3d_torch.main`` runs it (the same objects in the same order, the
rollout on the device when the mix says so), epoch after epoch.

Set-up writes the mix's training scenes (the configuration's training
scene, ``scenes`` of them, drawn from the mix's ``scene_seed``: the run's
seed moves the weights alone, so that every run does the same work) as
scans and a list, builds the model, the
engine, the dataset (augmented), the optimizer and the train step as
``main`` does, puts the benchmark's weights in the model, and runs the
first epoch: those steps build every kernel and are the steps the
comparison follows. The window runs further epochs; the harness hands
``train_one_epoch`` the train step wrapped, and the wrapper ends the window
at the first step that would start past its end. A step is counted when
it has returned and the device has finished it.

The comparison follows the first ``check_steps`` steps with the plain
reference: the same batches, made by the reference from the same seeds
(scans, augmentation, object subsets), the click sets that the program's
rollout fed each step, the same weights; its own backbone in training
mode, decoder, losses, gradients, clipping and AdamW, in float32. The
click sets are checked first: in ``check_rounds`` rounds of each compared
step's rollout, drawn from the run's seed, the reference's simulator
(``reference/clicks.py``) places the round's clicks on the labels the
program's round predicted (its clicks forced), takes the top ``num_obj``
clusters of each sample and orders them by the round's uniform draws (the
loop's generator seed, redrawn from the mix's ``program_seed``); every
round must keep the clicks before it, each at its slot. A click placed
otherwise reads as an infinite ``loss_gap``. Numbers compared: the first
step's loss (``loss_gap``, relative; the later steps' carry AdamW's
round-off, ``loss_gap_max``), the first step's decoder logits of every
round (``logit_err``: the largest difference over the largest reference
logit, the object columns in use and the sample's voxels, worst sample;
the reference follows the program's rounds), the first step's clipped
gradient as the optimizer's state holds it after one step (``grad_gap``)
and the parameters' change over the steps (``change_gap``), each of these
two by the median leaf (by the worst leaf: ``*_worst``, printed, not
compared: small BatchNorm leaves read as high on sound runs as on the
control, PERF.md). A leaf's gap is the gap between the program's norm and
the reference's over the larger of the reference's norm of that leaf and
of the median leaf. Leaves whose reference gradient is under a thousandth
of the median leaf's are left out.
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from benchmark.gen import scenes as gen
from benchmark.harness import stats
from benchmark.harness.runner import StopWindow, Window, scene_dir
from benchmark.harness.seeds import np_rng, torch_seed
from benchmark.harness.trace import span
from benchmark.kinds.program import load_weights, program_config
from benchmark.reference import clicks as rc
from benchmark.reference import judge
from benchmark.reference import model as rm
from benchmark.reference import train as rt


def setup(ctx):
    return TrainSession(ctx)


def lazy_levels(pyr):
    """Per level (valid rows, padded rows, present k3, k5, down, up pairs),
    the pairs as device scalars: read after the window, so that counting
    waits on nothing."""
    out = []
    for l in pyr.levels:
        z = torch.zeros((), dtype=torch.long, device=l.k3.device)
        out.append((l.num_valid, l.k3.shape[0], (l.k3 >= 0).sum(),
                    (l.k5 >= 0).sum() if l.k5 is not None else z,
                    (l.down >= 0).sum() if l.down is not None else z,
                    (l.up_parent >= 0).sum() if l.up_parent is not None
                    else z))
    return out


class TrainSession:
    def __init__(self, ctx):
        from agile3d_torch.data.datasets import build_dataset
        from agile3d_torch.engine.eval import InteractiveEngine
        from agile3d_torch.engine.train import (
            make_optimizer,
            make_train_step,
        )
        from agile3d_torch.models.agile3d import init_agile3d

        self.ctx = ctx
        cfg, tp = ctx.cell.config, ctx.cell.traffic
        self.cfg, self.tp = cfg, tp
        if not tp["device_rollout"]:
            raise NotImplementedError("the comparison follows the device "
                                      "rollout's draws")
        spec = cfg["scenes"]["train"]
        rng = np_rng(int(tp["scene_seed"]), "scenes")
        self.scenes = [gen.scene_from(spec, rng)
                       for _ in range(tp["scenes"])]
        scans, listing = gen.write_scan_list(scene_dir(ctx, "train"),
                                             self.scenes, int(spec["objects"]))
        self.weights = rm.make_weights(cfg, torch_seed(ctx.seed), ctx.device)
        # the program's own draws (batch order, object subsets, rollout
        # lengths and click orders, augmentation) from the mix's fixed
        # seed, so that every run does the same work
        self.seed = int(tp["program_seed"])
        pcfg = program_config(cfg, "float32", batch_size=tp["batch_size"],
                              prefetch=tp["prefetch"])
        self.pcfg = pcfg
        # main.py's order of set-up
        torch.manual_seed(self.seed)
        self.np_rng = np.random.default_rng(self.seed)
        self.py_rng = random.Random(self.seed)
        model = init_agile3d(pcfg.model, seed=self.seed, device="cpu")
        self.dataset = build_dataset("train", "multi_obj", scan_folder=scans,
                                     scene_list=listing,
                                     voxel_size=pcfg.model.voxel_size,
                                     seed=self.seed)
        engine = InteractiveEngine(pcfg, model, ctx.device)
        load_weights(engine.model, self.weights)
        steps = max(1, len(self.dataset) // pcfg.train.batch_size)
        optimizer, _ = make_optimizer(engine.model, pcfg, steps)
        self.program = (engine, make_train_step(pcfg, engine.model,
                                                optimizer), optimizer)
        self.names = [n for n, p in engine.model.named_parameters()
                      if p.requires_grad]
        self.p0 = {n: p.detach().clone()
                   for n, p in engine.model.named_parameters()}
        # the first epoch: every kernel built, and the steps compared
        self.record, self.feedback, self.rollouts, self.rounds = [], [], \
            [], []
        self.deadline = None
        model = engine.model
        decode = model.forward_mask

        def forward_mask(scene, clicks, num_obj, *a, **k):
            out = decode(scene, clicks, num_obj, *a, **k)
            grad = torch.is_grad_enabled()
            with torch.no_grad():
                if grad:
                    # the supervised pass: the labels each refinement
                    # round hands the next, and the first step's logits
                    lab = out["all_masks"][:-1].argmax(-1)
                    self.feedback.append(torch.where(
                        scene.vox_valid, lab, -1).to(torch.int16).cpu())
                    if not self.record:
                        self.logits0 = out["all_masks"].to(
                            "cpu", torch.float32, copy=True)
                else:
                    # a rollout round: the click table it was given and
                    # the labels it predicted
                    self.rounds.append(tuple(
                        t.to("cpu", copy=True) for t in clicks) + (
                        out["pred_masks"].argmax(-1).to(torch.int16).cpu(),))
            return out

        model.forward_mask = forward_mask
        self._epoch(0)
        del model.forward_mask
        self.p_end = {n: p.detach().clone()
                      for n, p in engine.model.named_parameters()}
        self.epoch = 1

    def _step(self, device_batch, clicks, labels, num_obj, dropout_gen=None):
        """The program's train step, as ``train_one_epoch`` calls it."""
        engine, step, optimizer = self.program
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline:
            raise StopWindow
        if self.counting is not None:
            self.counting.append(("step", lazy_levels(device_batch[0])))
        t = time.perf_counter()
        with span("step"):
            out = step(device_batch, clicks, labels, num_obj, dropout_gen)
            torch.cuda.synchronize() if labels.is_cuda else None
        now = time.perf_counter()
        if self.deadline is None:
            self.record.append((out["loss"].detach().clone(),
                                tuple(t.clone() for t in clicks)))
            self.rollouts.append(self.rounds)
            self.rounds = []
            if len(self.record) == 1:
                # AdamW's first moment after one step is 0.1 g
                self.grad0 = {n: optimizer.adamw.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).detach().clone() / 0.1
                    for n, p in zip(optimizer.names, optimizer.params)}
        elif now <= self.deadline or self.ctx.trace:
            self.done.append((now, int(labels.shape[0]), now - t))
            self.cut = len(self.counting) if self.counting is not None \
                else 0
        return out

    def _epoch(self, epoch: int):
        from agile3d_torch.engine.train import train_one_epoch

        engine = self.program[0]
        train_one_epoch(engine, self._step, self.dataset, self.pcfg, epoch,
                        np_rng=self.np_rng, py_rng=self.py_rng,
                        log=lambda *a, **k: None, print_freq=10 ** 9,
                        device_rollout=self.tp["device_rollout"])

    counting = None

    def window(self, deadline: float) -> Window:
        self.done, self.deadline, self.cut = [], deadline, 0
        self.counting = [] if self.ctx.trace else None
        unwrap = self._count_passes() if self.ctx.trace else None
        start = time.perf_counter()
        try:
            while True:
                self._epoch(self.epoch)
                self.epoch += 1
        except StopWindow:
            pass
        finally:
            if unwrap:
                unwrap()
        torch.cuda.synchronize() if self.ctx.device != "cpu" else None
        end = self.done[-1][0] if self.done else start
        scenes = sum(d[1] for d in self.done)
        steps = len(self.done)
        rate = stats.rate(scenes, start, end)
        return Window(
            e2e={"train_scenes_per_s": rate},
            samples={"steps": steps, "scenes": scenes,
                     "train_scenes_per_s": rate, "window_s": end - start,
                     "epochs_started": self.epoch - 1},
            layer={"steps": steps, "window_s": end - start,
                   "step_s": [d[2] for d in self.done],
                   "passes": self._read_counts(), "cut": self.cut},
            attempted=steps, failed=0)

    def _count_passes(self):
        """Traced runs only: each backbone and decoder pass of the program
        noted with its shapes (its pyramid's counts, its rows and click
        table width) and whether it ran with gradients."""
        model = self.program[0].model
        fb, fm = model.forward_backbone, model.forward_mask

        def backbone(pyr, *a, **k):
            self.counting.append(("backbone", torch.is_grad_enabled(),
                                  lazy_levels(pyr)))
            return fb(pyr, *a, **k)

        def mask(scene, clicks, *a, **k):
            b, n = scene.vox_valid.shape
            self.counting.append(("decoder", torch.is_grad_enabled(),
                                  scene.vox_valid.sum(), b,
                                  clicks.vox.shape[1]))
            return fm(scene, clicks, *a, **k)

        model.forward_backbone, model.forward_mask = backbone, mask

        def unwrap():
            del model.forward_backbone, model.forward_mask
        return unwrap

    def _read_counts(self):
        if self.counting is None:
            return None
        out = []
        for rec in self.counting:
            if rec[0] == "decoder":
                out.append(("decoder", rec[1], int(rec[2]), rec[3], rec[4]))
            else:
                levels = [tuple(int(x) for x in lv) for lv in rec[-1]]
                out.append((rec[0], rec[1] if rec[0] == "backbone" else None,
                            levels))
        return out

    def release(self):
        self.program = None

    # ------------------------------------------------------------ check

    def _batches(self):
        """The first epoch's batches as the reference makes them: the
        order, the subsample seeds and each step's rollout draws (its
        round count and its generator's seed) drawn as the loop draws
        them, the scans as the dataset loads and augments them."""
        rng = np.random.default_rng(self.seed)
        n = len(self.scenes)
        order = rng.permutation(n)
        bs = self.tp["batch_size"]
        groups = [order[i:i + bs] for i in range(0, n, bs)]
        seeds = rng.integers(2 ** 31, size=len(groups))
        py = random.Random(self.seed)
        aug = np.random.default_rng(self.seed)
        for ids, s in zip(groups, seeds):
            draws = (py.randint(0, 19), int(rng.integers(2 ** 31)))
            samples = []
            for j in ids:
                coords, colors, labels = self.scenes[int(j)]
                samples.append((rt.augment_coords(judge.min_shift(coords),
                                                  aug), colors, labels))
            yield samples, int(s), draws

    def _reference(self, prec, feedback=None, half=False, per_step=None):
        """The first ``check_steps`` steps of the reference from the
        benchmark's weights: (losses, the first clipped gradient, the
        parameters after the steps, the labels each step's rounds handed
        on). ``feedback`` per step: labels to follow (else its own).
        ``per_step(i, batch, draws, rounds)`` sees each step's batch and
        logits."""
        cfg, dev = self.cfg, self.ctx.device
        buffers = ("running_mean", "running_var", "gauss_B")
        params = {k: v.clone().requires_grad_(not k.endswith(buffers))
                  for k, v in self.weights.items()}
        opt = rt.AdamW({k: v for k, v in params.items() if v.requires_grad},
                       lr=self.pcfg.train.lr,
                       weight_decay=self.pcfg.train.weight_decay,
                       max_norm=self.pcfg.train.clip_max_norm)
        losses, grad0, handed = [], None, []
        max_obj = cfg["decoder"]["max_fg_objects"]
        for i, (samples, seed, draws) in enumerate(self._batches()):
            if i >= self.tp["check_steps"]:
                break
            batch = rt.Batch(samples, cfg["voxel_size"], dev, max_obj, seed)
            clicks = tuple(c.long() for c in self.record[i][1])
            fb = None if feedback is None else \
                feedback[i][..., :batch.labels.shape[1]].to(dev)
            loss, lab, rounds = rt.forward_loss(params, cfg, batch, clicks,
                                                prec, fb, half)
            if per_step is not None:
                per_step(i, batch, draws, rounds.detach())
            del rounds
            grads = torch.autograd.grad(loss, list(opt.params.values()),
                                        allow_unused=True)
            g = opt.step(dict(zip(opt.params, grads)))
            grad0 = g if grad0 is None else grad0
            losses.append(float(loss.detach()))
            handed.append(lab)
            del loss, grads, batch
        return losses, grad0, {k: v.detach() for k, v in params.items()}, \
            handed

    def _rollout_miss(self, i: int, batch, draws) -> bool:
        """Whether step ``i``'s rollout placed a click otherwise than the
        reference's simulator on the program's labels, in the rounds
        drawn from the run's seed; or changed a click of an earlier round
        in any round."""
        dev = self.ctx.device
        max_label = self.cfg["decoder"]["max_fg_objects"]
        n_iters, gen_seed = draws
        rounds = self.rollouts[i]
        if len(rounds) != n_iters:
            return True
        # the table each round starts from (round 0: empty), then the one
        # the supervised step was handed
        tables = [None] + [r[:3] for r in rounds] + [self.record[i][1]]
        tables[-1] = tuple(t.cpu() for t in tables[-1])
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        b_n = len(batch.rows)
        u = [torch.rand((b_n, max_label), generator=gen, device=dev).cpu()
             for _ in range(n_iters + 1)]
        pick = set(np_rng(self.ctx.seed, f"rounds{i}").choice(
            n_iters + 1, size=min(self.tp["check_rounds"], n_iters + 1),
            replace=False).tolist())
        for r in range(n_iters + 1):
            before, after = tables[r], tables[r + 1]
            for b in range(b_n):
                kept = [] if before is None else \
                    [tuple(int(t[b, j]) for t in before)
                     for j in range(int((before[0][b] >= 0).sum()))]
                have = [tuple(int(t[b, j]) for t in after)
                        for j in range(int((after[0][b] >= 0).sum()))]
                if have[:len(kept)] != kept or any(
                        int(after[0][b, j]) >= 0
                        for j in range(len(have), after[0].shape[1])):
                    return True
                if r not in pick:
                    continue
                rows = batch.rows[b]
                lab = batch.labels[b, :len(rows)]
                valid = lab >= 0
                if r == 0:
                    pred = torch.zeros_like(lab)
                else:
                    pred = rounds[r - 1][3][b, :len(rows)].long().to(dev)
                    live = before[0][b] >= 0
                    pred = judge.override(pred, before[0][b][live].to(dev),
                                          before[1][b][live].to(dev))[0]
                idx = torch.nonzero(valid)[:, 0]
                ranked = [c for c in rc.ranked_clusters(
                    pred[valid], lab[valid], batch.raw[rows][valid],
                    max_label) if math.isfinite(c[1])]
                ranked = ranked[:int(batch.num_obj[b])]
                placed = [(int(idx[first]), int(lab[idx[first]]))
                          for _, _, first in ranked]
                order = torch.argsort(u[r][b, :len(placed)], stable=True)
                want = kept + [placed[j] for j in order.tolist()]
                want = [(v, o, slot) for slot, (v, o, *_) in
                        enumerate(want)][:after[0].shape[1]]
                if have != want:
                    return True
        return False

    def check(self, control: str):
        """Sound runs: the program against the reference that follows its
        labels, after its rollouts' clicks are checked. ``control``
        "lower" (one precision step below the configuration's) or "half"
        (the loss of half of each batch, a planted fault): that
        computation in the program's place, against the reference that
        follows its labels."""
        seen = {}

        def first_logits(i, batch, draws, rounds):
            if i == 0:
                seen["theirs"] = rounds

        if control:
            low = rm.Precision(**self.tp["control"]) \
                if control == "lower" else rm.Precision()
            losses, grad0, p_end, handed = self._reference(
                low, half=control == "half", per_step=first_logits)
        else:
            losses = [float(x[0]) for x in self.record]
            grad0, p_end, handed = self.grad0, self.p_end, self.feedback
            seen["theirs"] = self.logits0
        miss = []

        def judge_step(i, batch, draws, rounds):
            if i == 0:
                seen["logit_err"] = logit_err(seen.pop("theirs"), rounds,
                                              batch)
            if not control:
                miss.append(self._rollout_miss(i, batch, draws))

        ref_losses, ref_grad0, ref_end, _ = self._reference(
            rm.Precision(), handed, per_step=judge_step)
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        if any(miss):
            gaps[0] = float("inf")
        norms = {k: float(torch.linalg.vector_norm(v)) for k, v in
                 ref_grad0.items()}
        med = float(np.median(list(norms.values())))
        leaves = [k for k in self.names if norms[k] >= 1e-3 * med]

        def by_leaf(prog: dict, ref: dict):
            ref_n = {k: float(torch.linalg.vector_norm(ref[k])) for k in
                     leaves}
            med_n = float(np.median(list(ref_n.values())))
            return {k: abs(float(torch.linalg.vector_norm(prog[k]))
                           - ref_n[k]) / max(ref_n[k], med_n)
                    for k in leaves}

        grad = by_leaf(grad0, ref_grad0)
        change = by_leaf({k: p_end[k] - self.p0[k] for k in leaves},
                         {k: ref_end[k] - self.p0[k] for k in leaves})
        for name, d in (("grad", grad), ("change", change)):
            top = sorted(d.items(), key=lambda kv: -kv[1])[:5]
            print(f"diag {name} median {float(np.median(list(d.values())))!r}"
                  f" worst {top!r}", file=sys.stderr)
        print(f"diag loss_gaps {gaps!r} rollout_miss {miss!r} left_out "
              f"{sorted(set(self.names) - set(leaves))!r}", file=sys.stderr)
        return [("loss_gap", gaps[0]),
                ("logit_err", seen["logit_err"]),
                ("grad_gap", float(np.median(list(grad.values())))),
                ("change_gap", float(np.median(list(change.values())))),
                ("loss_gap_max", max(gaps)),
                ("grad_gap_worst", max(grad.values())),
                ("change_gap_worst", max(change.values()))]


@torch.no_grad()
def logit_err(theirs: torch.Tensor, mine: torch.Tensor, batch) -> float:
    """The largest difference of a logit of any round, over the largest
    reference logit, on each sample's voxels and the object columns in
    use; the worst sample. theirs, mine [R, B, N, K] (theirs may be
    padded past the reference's N)."""
    theirs = theirs[:, :, :mine.shape[2]].to(mine.device)
    cols = torch.arange(mine.shape[-1], device=mine.device)
    worst = 0.0
    for b, rows in enumerate(batch.rows):
        use = cols <= int(batch.num_obj[b])
        m = mine[:, b, :len(rows)][..., use]
        t = theirs[:, b, :len(rows)][..., use]
        worst = max(worst, float((m - t).abs().max()
                                 / m.abs().max().clamp(min=1e-30)))
    return worst
