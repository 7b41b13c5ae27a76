"""Traffic kind ``serve``: the annotation server as ``run_ui`` builds it,
one annotator in a closed loop with no think time.

Set-up writes the pool's scenes (drawn from the mix's ``scene_seed``: the
run's seed moves the weights and the clicks, so that every run serves the
same scenes in the same order) in the tool's layout under the run's
temporary directory, builds ``InteractiveSegmentationServer`` (the mix's
decoder dtype, sessions recorded as the tool records them), puts the
benchmark's weights in its model and warms up the click buckets the
sessions reach. The window runs sessions: a scene load (not a click), then
``clicks_per_session`` calls of ``get_next_click``, round-robin over the
scene's objects, each on a point of its object drawn from the seed and
turned into a voxel by ``nearest_voxel`` as the tool's viewer does. A
click is timed from the call until its masks and IoU are on the host.

The comparison: a sample of the clicks served, drawn from the seed (one a
session and the last click of the first sessions). For each, the harness
keeps what the timed call produced: the decoder's logits of every round
(``forward_mask``'s ``all_masks``, taken as the call returns them), its
click table and the served masks and IoU. The plain reference (its own
voxels, nearest voxels, backbone and decoder, float32) follows the pass
round by round (``reference/judge.py::judge_pass``) and gives
``logit_err`` and ``logit_gap``: the served labels under its logits, with
a served IoU that is not the IoU of the served labels (beyond float32
rounding, ``IOU_TOL``) counted as an infinite gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.gen import scenes as gen
from benchmark.harness import stats
from benchmark.harness.runner import Window, scene_dir
from benchmark.harness.seeds import np_rng, torch_seed
from benchmark.harness.trace import span
from benchmark.kinds.program import load_weights, program_config
from benchmark.reference import judge
from benchmark.reference import model as rm

# a served IoU is a float32 mean of at most max_fg_objects ratios
IOU_TOL = 1e-5


def setup(ctx):
    return ServeSession(ctx)


class ServeSession:
    def __init__(self, ctx):
        from agile3d_torch.interactive import (
            InteractiveDataLoader,
            InteractiveSegmentationServer,
        )

        self.ctx = ctx
        cfg, tp = ctx.cell.config, ctx.cell.traffic
        self.cfg, self.tp = cfg, tp
        spec = cfg["scenes"]["eval"]
        rng = np_rng(int(tp["scene_seed"]), "scenes")
        self.scenes = [gen.scene_from(spec, rng) for _ in range(tp["pool"])]
        folder = gen.write_tool_scenes(scene_dir(ctx, "scenes"), self.scenes)
        self.weights = rm.make_weights(cfg, torch_seed(ctx.seed),
                                       ctx.device)
        pcfg = program_config(cfg, tp["decoder_dtype"])
        loader = InteractiveDataLoader(folder, "bench")
        server = InteractiveSegmentationServer(loader, None, pcfg,
                                               ctx.device, seed=0)
        load_weights(server.engine.model, self.weights)
        self.program = server
        self.armed, self.caught = False, None
        model = server.engine.model
        decode = model.forward_mask

        def forward_mask(scene, clicks, num_obj, *a, **k):
            out = decode(scene, clicks, num_obj, *a, **k)
            if self.armed:
                self.caught = (out["all_masks"], clicks, num_obj)
            return out

        model.forward_mask = forward_mask
        self.plan_rng = np_rng(ctx.seed, "clicks")
        self.n_obj = int(spec["objects"])
        self.obj_points = [[np.nonzero(lab == o)[0]
                            for o in range(1, self.n_obj + 1)]
                           for _, _, lab in self.scenes]
        # warm-up: a scene load and the click buckets the sessions reach
        warm = np_rng(ctx.seed, "warm-up")
        server.load_scene(0)
        for count in tp["warmup_click_counts"]:
            clicks = self._clicks(0, count, warm)
            idx, times = {"0": []}, {"0": []}
            for t, (o, p) in enumerate(clicks):
                self._add(idx, times, t, o, p)
            server.get_next_click(idx, times, record=tp["record"])

    def _clicks(self, scene: int, count: int, rng):
        """``count`` clicks on scene ``scene``: (object, point) pairs,
        round-robin over the objects."""
        out = []
        for k in range(count):
            o = k % self.n_obj + 1
            pts = self.obj_points[scene][o - 1]
            out.append((o, int(pts[rng.integers(len(pts))])))
        return out

    def _add(self, idx, times, t, o, p):
        """One click into the tool's dicts {obj: [voxel rows]}, {obj:
        [times]}: the voxel the viewer's lookup gives for the point."""
        coords = self.scenes[self.program.loader.index][0]
        row = self.program.nearest_voxel(coords[p])
        idx.setdefault(str(o), []).append(row)
        times.setdefault(str(o), []).append(t)

    def window(self, deadline: float) -> Window:
        server, tp = self.program, self.tp
        per = tp["clicks_per_session"]
        pick = np_rng(self.ctx.seed, "compare")
        lat, loads, self.kept, shapes = [], [], [], []
        sessions = 0
        start = time.perf_counter()
        end = start
        while time.perf_counter() < deadline:
            scene = sessions % tp["pool"]
            keep = set(pick.choice(per, tp["compare_per_session"],
                                   replace=False).tolist())
            if sessions < tp["compare_last_of_sessions"]:
                keep.add(per - 1)
            t = time.perf_counter()
            with span("scene_load"):
                server.load_scene(scene)
            loads.append(time.perf_counter() - t)
            plan = self._clicks(scene, per, self.plan_rng)
            idx, times = {"0": []}, {"0": []}
            for k in range(per):
                if time.perf_counter() >= deadline:
                    break
                with span("host"):
                    self._add(idx, times, k, *plan[k])
                self.armed = k in keep
                t = time.perf_counter()
                with span("click"):
                    pred_full, iou = server.get_next_click(
                        idx, times, record=tp["record"])
                done = time.perf_counter()
                self.armed = False
                if done > deadline and not self.ctx.trace:
                    break
                lat.append(done - t)
                shapes.append((server.n_valid, k + 1))
                end = done
                if k in keep:
                    masks, clicks, num_obj = self.caught
                    n = server.n_valid
                    self.kept.append((
                        scene, plan[:k + 1], masks[:, 0, :n].cpu(),
                        tuple(c[0].cpu() for c in clicks),
                        num_obj.cpu(), pred_full, iou))
                    self.caught = None
            sessions += 1
        ms = np.asarray(lat) * 1e3
        return Window(
            e2e={"click_ms_p95": stats.percentile(ms, 95)},
            samples={"clicks": len(lat), "sessions": sessions,
                     "click_ms_p50": stats.percentile(ms, 50),
                     "click_ms_p95": stats.percentile(ms, 95),
                     "scene_load_s_mean": float(np.mean(loads)),
                     "clicks_compared": len(self.kept),
                     "window_s": end - start},
            layer={"clicks": len(lat), "click_wall_s": float(np.sum(lat)),
                   "decoder_flops": self._flops(shapes)},
            attempted=len(lat), failed=0)

    def _flops(self, shapes) -> float:
        """The decoder's useful operations over the clicks of the window:
        each pass over the scene's voxels with the clicks it carries."""
        from benchmark.counts.costs import decoder_flops

        dec = self.cfg["decoder"]
        return float(sum(decoder_flops(n, dec["num_bg_queries"] + c, dec)
                         for n, c in shapes))

    def release(self):
        self.program = None

    @torch.no_grad()
    def check(self, control: str):
        cfg, dev = self.cfg, self.ctx.device
        q = cfg["voxel_size"]
        max_obj = cfg["decoder"]["max_fg_objects"]
        low = rm.Precision(**self.tp["control"]) if control else None
        err, gap = 0.0, 0.0
        refs = {}
        for scene, plan, masks, clicks, num_obj, pred_full, iou in self.kept:
            coords, colors, labels = self.scenes[scene]
            if scene not in refs:
                shifted = judge.min_shift(coords)
                refs[scene] = (shifted, judge.ref_scene(
                    self.weights, shifted, colors, labels, q, dev),
                    judge.ref_scene(self.weights, shifted, colors, labels,
                                    q, dev, low) if low else None)
            shifted, ref, ref_low = refs[scene]
            vox, obj, tim = (c.to(dev).long() for c in clicks)
            num_obj = num_obj.to(dev)
            if not self._same_voxels(ref, shifted, plan, vox):
                err = gap = float("inf")
                continue
            if low is None:
                rounds = masks.to(dev)
                served = torch.from_numpy(
                    np.asarray(pred_full, np.int64)).to(dev)
            else:
                # the control in the program's place: its own rounds
                rounds = rm.decoder(self.weights, cfg, ref_low.scene,
                                    vox[None], obj[None], tim[None],
                                    num_obj, low)[:, 0]
                live = vox >= 0
                served = judge.override(rounds[-1].argmax(1), vox[live],
                                        obj[live])[0][ref.vox.inverse]
                iou = judge.mean_iou(served, ref.labels_full, max_obj)
            v = judge.judge_pass(self.weights, cfg, ref, vox, obj, tim,
                                 num_obj, rounds, served)
            err, gap = max(err, v.logit_err), max(gap, v.logit_gap)
            if abs(iou - judge.mean_iou(served, ref.labels_full,
                                        max_obj)) > IOU_TOL:
                gap = float("inf")
        if not self.kept:
            err = gap = float("inf")
        return [("logit_err", err), ("logit_gap", gap)]

    def _same_voxels(self, ref, shifted, plan, vox) -> bool:
        """Whether each click's voxel in the table is the one the
        reference finds nearest to the clicked point, as the viewer asks
        (the table holds the clicks by object, in the dict's order)."""
        dev = self.ctx.device
        raw = torch.from_numpy(shifted).to(dev)[ref.vox.first]
        want = {}
        for t, (o, p) in enumerate(plan):
            xyz = torch.from_numpy(shifted[p]).to(dev)
            want.setdefault(o, []).append(
                int(((raw - xyz) ** 2).sum(1).argmin()))
        order = [r for o in sorted(want, key=lambda o: min(
            t for t, (oo, _) in enumerate(plan) if oo == o)) for r in want[o]]
        return vox[:len(order)].tolist() == order
