"""Traffic kind ``eval``: ``engine/eval.py::evaluate_dataset`` as ``python -m
agile3d_torch.eval_multi_obj`` runs it (the device rollout unless the mix
says otherwise, the mix's protocol), over a pool of scenes visited in
turn: each visit reads and prepares its scene again, as a dataset read
does.

Set-up writes the pool's scenes (the configuration's eval scene) as scans
and a list, builds the model and the engine as the CLI does, puts the
benchmark's weights in the model and evaluates the first scene once (every
kernel built, every click bucket the rollout reaches warmed). The window
evaluates an endless turn of the pool; the harness wraps the per-scene
call that ``evaluate_dataset`` makes (``evaluate_scene_device``) and ends
the window at the first scene that would start past its end. A round is a
decoder pass with its click override, IoU and simulated click; a scene's
rounds count when its rows are back on the host.

The comparison: the first ``compare_scenes`` scenes of the window, and in
each its first and last rounds and ``compare_rounds`` more drawn from the
seed. For those rounds the harness keeps what the timed rollout produced,
copied to the host as it goes (the decoder's logits of every refinement
round and the click table of the pass), and the scene's CSV rows. The
plain reference (its own voxels, backbone, decoder and click simulator,
float32) follows each kept pass round by round
(``reference/judge.py::judge_pass``: ``logit_err``, ``logit_gap``) and
holds each kept round's IoU row against its own (``iou_gap``). Where it
follows the program's state, it checks the stages it skips by
themselves: the first round's clicks (every cluster, in the protocol's
shuffled order) and each kept round's next click must be the clicks its
own simulator places on the program's labels, and each kept IoU row the
IoU of those labels (beyond float32 rounding, ``IOU_TOL``); a miss counts
as an infinite ``logit_err``.
"""

from __future__ import annotations

import time

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

# an IoU row is a float32 mean of at most max_fg_objects ratios
IOU_TOL = 1e-5


def setup(ctx):
    return EvalSession(ctx)


class Turn:
    """A dataset visited in turn, ``length`` items."""

    def __init__(self, base, length: int):
        self.base, self.length = base, length

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return self.base[i % len(self.base)]


class EvalSession:
    def __init__(self, ctx):
        import agile3d_torch.engine.eval as engine_eval
        from agile3d_torch.data.datasets import build_dataset
        from agile3d_torch.models.agile3d import init_agile3d

        self.ctx = ctx
        cfg, tp = ctx.cell.config, ctx.cell.traffic
        self.cfg, self.tp = cfg, tp
        spec = cfg["scenes"]["eval"]
        rng = np_rng(ctx.seed, "scenes")
        self.scenes = [gen.scene_from(spec, rng) for _ in range(tp["pool"])]
        scans, listing = gen.write_scan_list(scene_dir(ctx, "eval"),
                                             self.scenes, int(spec["objects"]))
        self.weights = rm.make_weights(cfg, torch_seed(ctx.seed), ctx.device)
        pcfg = program_config(cfg, "float32")
        model = init_agile3d(pcfg.model, seed=0, device="cpu")
        engine = engine_eval.InteractiveEngine(pcfg, model, ctx.device)
        load_weights(engine.model, self.weights)
        self.dataset = build_dataset("val", "multi_obj", scan_folder=scans,
                                     scene_list=listing,
                                     voxel_size=pcfg.model.voxel_size)
        self.program = engine
        # the protocol's first-round shuffle, eval_multi_obj's default seed
        self.eval_seed = int(tp["protocol_seed"])
        self.results = scene_dir(ctx, "results")
        # the per-scene call and the decoder, wrapped
        self.module = engine_eval
        self.scene_call = engine_eval.evaluate_scene_device
        engine_eval.evaluate_scene_device = self._scene
        decode = engine.model.forward_mask
        engine.model.forward_mask = lambda *a, **k: self._decode(decode, *a,
                                                                 **k)
        self.deadline, self.keep, self.done = None, {}, []
        self.counting = None
        self._run(Turn(self.dataset, 1))     # warm-up

    # ---------------------------------------------------------- the path

    def _run(self, dataset):
        from agile3d_torch.engine.eval import evaluate_dataset

        evaluate_dataset(self.program, dataset,
                         f"{self.results}/val_results.csv",
                         max_num_clicks=int(self.cfg["max_num_clicks"]),
                         seed=self.eval_seed, log=lambda *a, **k: None,
                         device_rollout=self.tp["device_rollout"],
                         mode=self.tp["mode"])

    def _scene(self, engine, batch, *, instance_id, **kw):
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline:
            raise StopWindow
        self.calls = 0
        self.kept_now = self.keep.get(instance_id, {}) \
            if self.deadline is not None else {}
        with span("scene"):
            rows = self.scene_call(engine, batch, instance_id=instance_id,
                                   **kw)
        now = time.perf_counter()
        if self.deadline is not None and (now <= self.deadline
                                          or self.ctx.trace):
            self.done.append((now, len(rows) - 1))
            if instance_id in self.keep:
                self.rows[instance_id] = [float(r.split(" ")[4])
                                          for r in rows]
                self.final[instance_id] = self.last_table
        return rows

    def _decode(self, decode, scene, clicks, num_obj, *a, **k):
        out = decode(scene, clicks, num_obj, *a, **k)
        self.calls += 1
        if self.counting is not None:
            self.counting.append(("decoder", torch.is_grad_enabled(),
                                  scene.vox_valid.sum(), scene.vox_valid
                                  .shape[0], clicks.vox.shape[1]))
        self.last_table = clicks
        if self.deadline is None:
            self.shape = out["all_masks"][:, 0].shape
        elif self.calls in self.kept_now:
            # the pass as the rollout produced it, copied to host memory
            # made ready in set-up, in the stream's order (no wait)
            host = self.kept_now[self.calls]
            m = out["all_masks"][:, 0]
            buf = self.pinned.pop() if self.pinned and \
                self.pinned[-1].shape == m.shape else _pinned(m.shape)
            host["masks"] = buf
            buf.copy_(m, non_blocking=True)
            w = clicks.vox.shape[1]
            host["table"] = tuple(t[:w].copy_(c[0], non_blocking=True)
                                  for t, c in zip(self.tables.pop(), clicks))
        return out

    def window(self, deadline: float) -> Window:
        cfg, tp = self.cfg, self.tp
        n_obj = int(cfg["scenes"]["eval"]["objects"])
        rounds = n_obj * int(cfg["max_num_clicks"]) - n_obj + 1
        pick = np_rng(self.ctx.seed, "compare")
        self.keep = {}
        for i in range(tp["compare_scenes"]):
            rs = {1, rounds} | set((pick.choice(rounds - 2, tp[
                "compare_rounds"], replace=False) + 2).tolist())
            self.keep[i] = {r: {} for r in sorted(rs)}
        self.rows, self.final = {}, {}
        kept = sum(len(v) for v in self.keep.values())
        self.pinned = [_pinned(self.shape) for _ in range(kept)]
        mc = cfg["decoder"]["max_clicks"]
        self.tables = [tuple(_pinned((mc,), torch.int32) for _ in range(3))
                       for _ in range(kept)]
        self.done, self.deadline = [], deadline
        self.counting = [] if self.ctx.trace else None
        bb_events = self._time_backbone() if self.ctx.trace else None
        start = time.perf_counter()
        try:
            self._run(Turn(self.dataset, 10 ** 6))
        except StopWindow:
            pass
        torch.cuda.synchronize() if self.ctx.device != "cpu" else None
        end = self.done[-1][0] if self.done else start
        n_rounds = sum(r for _, r in self.done)
        rate = stats.rate(n_rounds, start, end)
        layer = {"scenes": len(self.done), "window_s": end - start}
        if bb_events is not None:
            self.program.run_backbone = self._run_backbone
            ms = [a.elapsed_time(b) for a, b in bb_events]
            layer["backbone_ms"] = ms
            layer["passes"] = self._read_counts()
            layer["rows"] = self.rows_padded
        return Window(
            e2e={"eval_rounds_per_s": rate},
            samples={"scenes": len(self.done), "rounds": n_rounds,
                     "eval_rounds_per_s": rate, "window_s": end - start},
            layer=layer, attempted=len(self.done), failed=0)

    def _time_backbone(self):
        """Traced runs only: CUDA events around each scene's backbone, and
        its pyramid's counts noted."""
        from benchmark.kinds.train import lazy_levels

        engine = self.program
        self._run_backbone = run = engine.run_backbone
        events = []

        def run_backbone(batch, *a, **k):
            e0, e1 = _Event(), _Event()
            e0.record()
            out = run(batch, *a, **k)
            e1.record()
            events.append((e0, e1))
            pyr = engine.device_batch(batch)[0]
            self.counting.append(("backbone", False, lazy_levels(pyr)))
            self.rows_padded = pyr.levels[0].k3.shape[0]
            return out

        engine.run_backbone = run_backbone
        return events

    def _read_counts(self):
        out = []
        for rec in self.counting:
            if rec[0] == "decoder":
                out.append(("decoder", rec[1], int(rec[2]), rec[3], rec[4]))
            else:
                out.append(("backbone", rec[1],
                            [tuple(int(x) for x in lv) for lv in rec[2]]))
        return out

    def release(self):
        self.module.evaluate_scene_device = self.scene_call
        self.program = None

    # ------------------------------------------------------------ check

    @torch.no_grad()
    def check(self, control: str):
        import random

        cfg, dev = self.cfg, self.ctx.device
        q = cfg["voxel_size"]
        max_label = cfg["decoder"]["max_fg_objects"]
        low = rm.Precision(**self.tp["control"]) if control else None
        err = gap = iou_gap = 0.0
        miss = False
        n_obj = int(cfg["scenes"]["eval"]["objects"])
        compared = [i for i in self.keep if i in self.rows]
        for inst in compared:
            coords, colors, labels = self.scenes[inst % len(self.scenes)]
            shifted = judge.min_shift(coords)
            ref = judge.ref_scene(self.weights, shifted, colors, labels, q,
                                  dev)
            ref_low = judge.ref_scene(self.weights, shifted, colors, labels,
                                      q, dev, low) if low else None
            raw = torch.from_numpy(shifted).to(dev)[ref.vox.first]
            lab_v = ref.labels_full[ref.vox.first]
            final = tuple(c[0].to(dev).long() for c in self.final[inst])
            # the first round's clicks, in the protocol's shuffled order
            rng = random.Random(self.eval_seed)
            for _ in range(inst):
                rng.shuffle(list(range(n_obj)))
            first = rc.first_round(lab_v, raw, max_label, rng)
            if list(zip(final[0][:len(first)].tolist(),
                        final[1][:len(first)].tolist())) != first:
                miss = True
            rows = self.rows[inst]
            last = len(rows) - 1
            for r, kept in self.keep[inst].items():
                if "masks" not in kept:
                    continue
                vox, obj, tim = (c.to(dev).long() for c in kept["table"])
                num_obj = torch.tensor([n_obj], device=dev)
                n = len(ref.vox.grid)
                if low is None:
                    rounds = kept["masks"].to(dev)[:, :n]
                    iou = rows[r]
                else:
                    rounds = rm.decoder(self.weights, cfg, ref_low.scene,
                                        vox[None], obj[None], tim[None],
                                        num_obj, low)[:, 0]
                    iou = None
                live = vox >= 0
                theirs = judge.override(rounds[-1].argmax(1), vox[live],
                                        obj[live])[0]
                own_iou = judge.mean_iou(theirs[ref.vox.inverse],
                                         ref.labels_full, max_label)
                if iou is None:
                    iou = own_iou
                if abs(iou - own_iou) > IOU_TOL:
                    miss = True
                v = judge.judge_pass(self.weights, cfg, ref, vox, obj, tim,
                                     num_obj, rounds)
                err, gap = max(err, v.logit_err), max(gap, v.logit_gap)
                iou_gap = max(iou_gap, abs(iou - v.iou))
                if r < last and low is None:
                    # the click after this round: the one the reference's
                    # simulator places on the program's labels
                    slot = int(live.sum())
                    want = rc.next_click(theirs, lab_v, raw, max_label)
                    got = (int(final[0][slot]), int(final[1][slot])) \
                        if slot < len(final[0]) else None
                    if want is None:    # converged: the table adds none
                        got = None if got is None or got[0] < 0 else got
                    if want != got:
                        miss = True
        if not compared or miss:
            err = float("inf")
        return [("logit_err", err), ("logit_gap", gap), ("iou_gap", iou_gap)]


class _Event:
    """A CUDA event where there is a card, the host clock elsewhere."""

    def __init__(self):
        self.ev = torch.cuda.Event(enable_timing=True) \
            if torch.cuda.is_available() else None

    def record(self):
        if self.ev is not None:
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(end.ev)
        return 1e3 * (end.t - self.t)


def _pinned(shape, dtype=torch.float32):
    """Host memory the device can copy into without waiting."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())
