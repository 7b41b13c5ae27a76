#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agile3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  -- the card, its power limit, and the build of the CUDA kernels
                from ``agile3d_torch/csrc`` (one nvcc per source, all at once);
  2. kernels -- each kernel at the main paths' shapes (the eval smoke
                scene's neighbour maps; the training batch's for the
                training forward, dX and dW) against its plain PyTorch
                version on the card, with device times from CUDA events
                (median of 10 after warm-up, each call behind a short spin
                kernel so that the host's launch work is not timed) for the
                kernel, the plain version and a library yardstick (one bf16
                gather and one cuBLAS matmul, timed here only), beside the
                card's least time for the same work;
  3. probes -- the kernels of the TPU probes' counterparts: the windowed
                banded k3 conv (its plan covers every neighbour of the
                smoke scene's two finest maps) at the eval k3 shapes against
                its plain version and ``banded_conv_reference``, timed
                beside ``banded_conv``; the shared-memory row gather at the
                TPU probe's shape, exact against ``x[idx]``; then both
                probe entry points (``agile3d_torch.tools``, in process),
                with the two kernels' launches counted around them;
  4. reference -- the full-width model on a mid-size scene on the card
                (kernels on, then off) against the same model on the CPU,
                the plain float32 path that the CPU tests hold against the
                JAX package;
  5. train reference -- one supervised step at full width on two such
                scenes: the CPU (plain f32), the card with the kernels off
                and the card with them on; losses, every gradient, gnorm
                and the committed BatchNorm statistics compared, launches
                counted;
  6. main path -- ``python -m agile3d_torch.eval_multi_obj`` (in process) on
                the synthetic smoke scene (400,000 points, 8 objects) at full
                Res16UNet34C width with seeded random weights, 2 clicks per
                object, with the kernels' launch counts read around it (the
                probes' kernels: 0);
  7. train main path -- ``python -m agile3d_torch.main`` (in process): 15
                synthetic scenes of ~94,000 voxels, batch 5 (the 524,288-row
                level-0 bucket), one epoch of 3 steps and one validation at
                full width, launches counted per step (24 k3, 8 dW, 0
                stem; the probes' kernels 0), the rollout, the supervised
                step and the backbone's forward and backward timed with
                CUDA events.

Then the kernels line, the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SMOKE_SCENE = dict(num_scenes=1, num_obj=8, n_points=400000, extent=8.0, seed=0)
REF_SCENE = dict(num_scenes=1, num_obj=4, n_points=60000, extent=4.0, seed=1)
MAX_NUM_CLICKS = 2
# training: 15 scenes of ~94,000 voxels (ScanNet-sized), 5 per batch, so
# every batch pads to the 524,288-row level-0 bucket; 3 steps in one epoch
TRAIN_SCENES = dict(num_scenes=15, num_obj=8, n_points=190000, extent=6.0,
                    seed=2)
TRAIN_BATCH = 5
TRAIN_STEPS = 3
# the training reference: two scenes of ~25,000 voxels in one batch (a
# 65,536-row level 0, so its four k3 convs take the kernels), small enough
# for two full-width steps on the CPU
TRAIN_REF_SCENES = dict(num_scenes=2, num_obj=4, n_points=36000, extent=4.0,
                        seed=1)
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj, allow_nan=False), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def finite(x):
    return None if x is None or not math.isfinite(x) else x


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls on the card: CUDA
    events, each call enqueued behind a short spin kernel so that the
    wrapper's host time is not counted (``agile3d_torch.tools.time_ms``)."""
    from agile3d_torch.tools import time_ms as timed

    return timed(fn, torch.device(DEVICE), reps=reps, warmup=warmup)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(nbr, cin: int, cout: int) -> tuple[float, str]:
    """Least time for y = sum_j bf16(x[nbr[:, j]]) @ bf16(w[j]) on the card:
    each input read once and the output written once, against the products
    this map's present neighbours need at the bf16 tensor-core peak."""
    n, k = nbr.shape
    nnz = int((nbr >= 0).sum())
    flops = 2.0 * nnz * cin * cout
    nbytes = 4.0 * (n * cin + n * k + k * cin * cout + n * cout)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def tpu_kernel(module: str, func: str) -> str:
    """``file:line`` of the Pallas kernel that a CUDA kernel replaces: the
    definition of ``func`` in ``ops/<module>`` of the JAX package beside the
    port, or in ``tools/<module>`` for the TPU probes (read as text; nothing
    of either is imported)."""
    port = os.path.join(ROOT, "agile3d_torch")
    paths = sorted(glob.glob(os.path.join(ROOT, "*", "ops", module)))
    paths.append(os.path.join(ROOT, "tools", module))
    for path in paths:
        if path.startswith(port + os.sep) or not os.path.exists(path):
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if line.startswith(f"def {func}("):
                    return f"{os.path.relpath(path, ROOT)}:{i}"
    fail(f"no definition of {func} in ops/{module} of the JAX package or in "
         f"tools/{module}")


def phase_device(torch, cuda_build):
    t0 = time.time()
    reports = cuda_build.build()
    build_s = time.time() - t0
    for name in cuda_build.SOURCES:
        check(os.path.exists(cuda_build.library_path(name)),
              f"kernel library {name} missing after the build")
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "built": sorted(reports),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if any(w in ln for w in ("entry function",
                                                 "registers", "spill",
                                                 "warning"))]
                    for k, v in reports.items()}})


def kernel_cases(eval_pyr, train_pyr):
    """(kernel, role, level, cin, cout, count) at the main paths' shapes.
    ``count`` is the launches per unit of the role: per eval backbone
    forward for "eval"; per training step for the rest. At each of the two
    finest levels the first block of block8 / block7 takes 128 -> 96 and
    the other three k3 convs 96 -> 96; a training step runs them forward
    twice (the rollout's backbone and the supervised one), and their
    backward once: dX on the forward kernel (96 -> 128, 96 -> 96) and dW."""
    cases = [("banded_conv", "eval", lv, cin, 96, per)
             for lv in eval_pyr.levels[:2] for cin, per in ((128, 1), (96, 3))]
    cases.append(("banded_stem", "eval", eval_pyr.levels[0], 3, 32, 1))
    for lv in train_pyr.levels[:2]:
        cases += [("banded_conv", "train forward", lv, 128, 96, 2),
                  ("banded_conv", "train forward", lv, 96, 96, 6),
                  ("banded_conv", "dX", lv, 96, 128, 1),
                  ("banded_conv", "dX", lv, 96, 96, 3),
                  ("banded_conv_dw", "dW", lv, 128, 96, 1),
                  ("banded_conv_dw", "dW", lv, 96, 96, 3)]
    return cases


def phase_kernels(torch, cases):
    """Kernel vs plain version on the card at the main paths' shapes."""
    from agile3d_torch.ops.banded_conv import (
        banded_conv,
        banded_conv_dw,
        banded_conv_dw_reference,
        banded_conv_reference,
    )
    from agile3d_torch.ops.banded_stem import (
        banded_stem_conv,
        banded_stem_conv_reference,
    )

    fns = {"banded_conv": (banded_conv, banded_conv_reference),
           "banded_stem": (banded_stem_conv, banded_stem_conv_reference),
           "banded_conv_dw": (banded_conv_dw, banded_conv_dw_reference)}
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for name, role, lv, cin, cout, count in cases:
        kern, plain = fns[name]
        nbr = lv.k5 if name == "banded_stem" else lv.k3
        n, k = nbr.shape
        x = torch.randn((n, cin), generator=g, device=DEVICE)
        x[lv.num_valid:] = 0.0
        opts = {}
        if name == "banded_conv_dw":
            # the cotangent of the conv's output: zero on pad rows
            other = torch.randn((n, cout), generator=g, device=DEVICE)
            other[lv.num_valid:] = 0.0
        elif role == "dX":
            # as BandedConv's backward calls it: the forward's [k, cout,
            # cin] weights, read as flip(w, 0).transpose(1, 2)
            other = torch.randn((k, cout, cin), generator=g, device=DEVICE) \
                * (k * cin) ** -0.5
            opts = {"transposed": True}
        else:
            other = torch.randn((k, cin, cout), generator=g, device=DEVICE) \
                * (k * cin) ** -0.5
        run = lambda: kern(x, nbr, other, **opts)
        plain_other = other.flip(0).transpose(1, 2) if opts else other
        y = run()
        ref = plain(x, nbr, plain_other)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        ref_max = float(ref.abs().max())
        tol = 1e-3 * (ref_max + 1.0)
        tag = f"{name} ({role}) {n}x{cin}->{cout}"
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
        check(err <= tol, f"{tag}: max|kernel - plain| {err} > {tol}")
        if name != "banded_conv_dw" and n > lv.num_valid:
            pad_max = float(y[lv.num_valid:].abs().max())
            check(pad_max == 0.0, f"{tag}: pad rows {pad_max}")

        # yardstick: one bf16 row gather (-1 picks the appended zero row) and
        # one cuBLAS matmul over [n, k*cin]
        xz = torch.cat([x, x.new_zeros((1, cin))]).to(torch.bfloat16)
        idx = nbr.long()
        if name == "banded_conv_dw":
            ob = other.to(torch.bfloat16)
            lib = time_ms(torch, lambda: xz[idx].view(n, k * cin).T @ ob)
        else:
            ob = plain_other.to(torch.bfloat16).reshape(k * cin, cout)
            lib = time_ms(torch, lambda: xz[idx].view(n, k * cin) @ ob)
        b_ms, b_by = bound(nbr, cin, cout)
        row = dict(kernel=name, role=role, rows=n, cin=cin, cout=cout,
                   count=count, num_valid=lv.num_valid, max_abs_err=err,
                   ref_max=ref_max, tol=tol,
                   rel_err=err / max(ref_max, 1e-30),
                   ms=time_ms(torch, run),
                   plain_ms=time_ms(torch, lambda: plain(x, nbr, plain_other)),
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_parity", **row})
        rows.append(row)
        del x, other, plain_other, y, ref, xz, idx, ob
        torch.cuda.empty_cache()
    return rows


def phase_probes(torch, eval_pyr, eval_dev):
    """The probes' kernels against their plain versions on the card, then
    the probe entry points with the launches counted. ``eval_pyr`` is the
    smoke scene's pyramid on the host, ``eval_dev`` the same on the card."""
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_reference
    from agile3d_torch.ops.banded_window import (
        banded_window_conv,
        banded_window_conv_reference,
        max_window_rows,
        window_plan,
        window_stats,
        window_work,
    )
    from agile3d_torch.ops.row_gather import (
        gather_work,
        row_gather_reference,
        smem_row_gather,
    )
    from agile3d_torch.tools import (
        bound_ms,
        probe_banded_kernel,
        probe_smem_gather,
    )

    g = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    # the eval backbone's k3 convs at the two finest levels: 128 -> 96 once
    # and 96 -> 96 three times each
    for lv, lv_d in zip(eval_pyr.levels[:2], eval_dev.levels[:2]):
        nbr = lv_d.k3
        n, k = nbr.shape
        plan = window_plan(lv.k3, max_rows=max_window_rows(k, 128, 96))
        stats = window_stats(lv.k3, plan)
        emit({"phase": "probe_plan", "rows": n, **stats})
        check(plan.covers, f"the window plan of the {n}-row map does not "
                           f"cover every present neighbour")
        plan_d = plan.to(DEVICE)
        for cin, count in ((128, 1), (96, 3)):
            x = torch.randn((n, cin), generator=g, device=DEVICE)
            x[lv.num_valid:] = 0.0
            w = torch.randn((k, cin, 96), generator=g, device=DEVICE) \
                * (k * cin) ** -0.5
            y = banded_window_conv(x, nbr, plan_d, w)
            ref = banded_window_conv_reference(x, nbr, plan_d, w)
            full = banded_conv_reference(x, nbr, w)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            err_full = float((y - full).abs().max())
            ref_max = float(ref.abs().max())
            tol = 1e-3 * (ref_max + 1.0)
            tag = f"banded_window_conv {n}x{cin}->96"
            check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
            check(err <= tol, f"{tag}: max|kernel - plain| {err} > {tol}")
            check(err_full <= tol, f"{tag}: max|kernel - banded_conv_reference|"
                                   f" {err_full} > {tol}")
            pad_max = float(y[lv.num_valid:].abs().max())
            check(pad_max == 0.0, f"{tag}: pad rows {pad_max}")
            # the yardstick of banded_conv's rows: one bf16 row gather and
            # one cuBLAS matmul over [n, k*cin]
            xz = torch.cat([x, x.new_zeros((1, cin))]).to(torch.bfloat16)
            idx = nbr.long()
            ob = w.to(torch.bfloat16).reshape(k * cin, 96)
            b_ms, b_by = bound_ms(*window_work(nbr, plan_d, cin, 96))
            row = dict(
                kernel="banded_window_conv", role="eval shapes", rows=n,
                cin=cin, cout=96, count=count, num_valid=lv.num_valid,
                max_abs_err=err, max_abs_err_vs_full=err_full,
                ref_max=ref_max, tol=tol,
                ms=time_ms(torch, lambda: banded_window_conv(x, nbr, plan_d, w)),
                banded_conv_ms=time_ms(torch, lambda: banded_conv(x, nbr, w)),
                plain_ms=time_ms(torch, lambda: banded_window_conv_reference(
                    x, nbr, plan_d, w)),
                library_ms=time_ms(torch, lambda: xz[idx].view(n, k * cin) @ ob),
                bound_ms=b_ms, bound_by=b_by)
            emit({"phase": "probe_parity", **row})
            rows.append(row)
            del x, w, y, ref, full, xz, idx, ob

    # the row gather at the TPU probe's shape: 27 x 1024 rows of a table
    # that fits one block's shared memory
    w_rows, c, m = (probe_smem_gather.SMEM_ROWS, probe_smem_gather.CHANNELS,
                    probe_smem_gather.GATHERS)
    x = torch.rand((w_rows, c), generator=g, device=DEVICE)
    idx = torch.randint(0, w_rows, (m,), generator=g, device=DEVICE,
                        dtype=torch.int32)
    out = smem_row_gather(x, idx)
    torch.cuda.synchronize()
    check(torch.equal(out, row_gather_reference(x, idx)),
          "smem_row_gather differs from x[idx]")
    b_ms, b_by = bound_ms(*gather_work(w_rows, c, m))
    row = dict(kernel="smem_row_gather", role="probe shape", rows=m, cin=c,
               cout=c, count=1, table_rows=w_rows, max_abs_err=0.0,
               ms=time_ms(torch, lambda: smem_row_gather(x, idx)),
               plain_ms=time_ms(torch, lambda: row_gather_reference(x, idx)),
               library_ms=time_ms(torch, lambda: torch.index_select(x, 0, idx)),
               bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "probe_parity", **row})
    rows.append(row)
    del x, idx, out
    torch.cuda.empty_cache()

    # the probe path: both entry points at the smoke scene's level 0
    def log(msg):
        print(f"probe: {msg}", flush=True)

    t0 = time.time()
    banded_window_conv.launches = smem_row_gather.launches = 0
    k3 = eval_pyr.levels[0].k3
    banded = probe_banded_kernel.run(k3, probe_banded_kernel.CIN,
                                     probe_banded_kernel.COUT, DEVICE, g,
                                     log=log)
    gather = probe_smem_gather.run(k3, DEVICE, g, log=log)
    torch.cuda.synchronize()
    launches = {"banded_window_conv": banded_window_conv.launches,
                "smem_row_gather": smem_row_gather.launches}
    emit({"phase": "probes", "launches": launches,
          "banded": {key: v for key, v in banded.items() if key != "plan"},
          "gather": gather, "seconds": time.time() - t0})
    check(banded["covers"], "the probe's plan does not cover the map")
    check(banded["max_abs_err"] <= 1e-3 * (banded["ref_max"] + 1.0),
          f"probe: window kernel vs plain {banded['max_abs_err']}")
    check(gather["a_equal"], "probe: smem_row_gather differs from x[idx]")
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was not launched on the probe path: {launches}")
    return rows, launches


def _clicks(torch, labels, num_obj):
    """One click on the first voxel of each object and of the background."""
    from agile3d_torch.models.agile3d import ClickState

    vox, obj = [], []
    for o in range(num_obj + 1):
        rows = (labels == o).nonzero()[0]
        if len(rows):
            vox.append(int(rows[0]))
            obj.append(o)
    mc = 32
    pad = mc - len(vox)
    t = lambda v: torch.tensor([v + [0] * pad], dtype=torch.int32)
    return ClickState(torch.tensor([vox + [-1] * pad], dtype=torch.int32),
                      t(obj), t(list(range(len(vox)))))


def phase_reference(torch, tmp):
    """The full-width model on the card against the CPU's plain f32 path."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.ops.banded_conv import banded_conv
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.sparse.grid import to_device

    t0 = time.time()
    cfg = Config()
    scans, val_list = write_benchmark(os.path.join(tmp, "ref"), **REF_SCENE)
    batch = collate_scenes(
        [InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)[0]],
        cfg.buckets)
    n_valid = int((batch.sample_idx[0] >= 0).sum())
    num_obj = int(batch.num_obj[0])
    clicks = _clicks(torch, batch.labels[0, :n_valid], num_obj)

    def run(model, device):
        with torch.no_grad():
            pyr = to_device(batch.pyramid, device)
            arrays = [torch.from_numpy(a).to(device)
                      for a in (batch.feats, batch.raw, batch.sample_idx)]
            scene = model.forward_backbone(pyr, *arrays)
            out = model.forward_mask(
                scene, type(clicks)(*(t.to(device) for t in clicks)),
                torch.tensor([num_obj], dtype=torch.int32, device=device))
            return out["pred_masks"][0, :n_valid, :num_obj + 1].float().cpu()

    model = init_agile3d(cfg.model, seed=0, device="cpu")
    ref = run(model, "cpu")
    gpu = copy.deepcopy(model).to(DEVICE)
    banded_conv.launches = banded_stem_conv.launches = 0
    got_kern = run(gpu, DEVICE)
    launches = (banded_conv.launches, banded_stem_conv.launches)
    gpu.backbone.cfg = dataclasses.replace(gpu.backbone.cfg, banded_conv=False)
    got_plain = run(gpu, DEVICE)
    check(banded_conv.launches == launches[0], "kernel launched with it off")

    scale = float(ref.abs().max()) + 1.0
    err_plain = float((got_plain - ref).abs().max())
    err_kern = float((got_kern - ref).abs().max())
    labels = ref.argmax(-1)
    agree_plain = float((got_plain.argmax(-1) == labels).float().mean())
    agree_kern = float((got_kern.argmax(-1) == labels).float().mean())
    row = {"phase": "reference", "rows": batch.pyramid.levels[0].grid.shape[0],
           "num_valid": n_valid, "launches_k3": launches[0],
           "launches_stem": launches[1], "logit_scale": scale,
           "plain_max_abs_err": err_plain, "plain_label_agree": agree_plain,
           "kernel_max_abs_err": err_kern, "kernel_label_agree": agree_kern,
           "seconds": time.time() - t0}
    emit(row)
    # level 0 of this scene is a 49,152-row bucket: the stem and the four k3
    # convs of block8 take the kernels, level 1 is below the threshold
    check(launches == (4, 1), f"reference run launches {launches} != (4, 1)")
    # f32 on both sides, summed in other orders
    check(err_plain <= 1e-3 * scale, f"card f32 vs CPU f32: {err_plain}")
    check(agree_plain >= 0.999, f"card f32 labels agree {agree_plain}")
    # the kernels round their operands to bf16 (8-bit mantissa)
    check(err_kern <= 5e-2 * scale, f"card kernels vs CPU f32: {err_kern}")
    check(agree_kern >= 0.99, f"card kernel labels agree {agree_kern}")


def phase_main_path(torch, scans, val_list, out_dir):
    """The eval entry point on the smoke scene, with the kernels' launches
    counted around it and the backbone / decoder timed with CUDA events."""
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.engine import eval as peval
    from agile3d_torch.ops.banded_conv import banded_conv
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.row_gather import smem_row_gather

    events = {"backbone": [], "mask": []}
    seen = {}
    orig = {"backbone": peval.InteractiveEngine.run_backbone,
            "mask": peval.InteractiveEngine.run_mask}

    def timed(key):
        def wrapper(self, *args, **kwargs):
            seen["engine"] = self
            if key == "backbone":
                seen["batch"] = args[0]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig[key](self, *args, **kwargs)
            end.record()
            events[key].append((start, end))
            return out
        return wrapper

    peval.InteractiveEngine.run_backbone = timed("backbone")
    peval.InteractiveEngine.run_mask = timed("mask")
    args = eval_multi_obj.get_args_parser().parse_args([
        "--scan_folder", scans, "--val_list", val_list, "--seed", "0",
        "--max_num_clicks", str(MAX_NUM_CLICKS), "--output_dir", out_dir,
        "--device", DEVICE])
    logged = []

    def log(msg):
        logged.append(msg)
        print(f"eval_multi_obj: {msg}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        banded_conv.launches = banded_stem_conv.launches = 0
        banded_window_conv.launches = smem_row_gather.launches = 0
        results = eval_multi_obj.main(args, log=log)
        torch.cuda.synchronize()
        launches = {"banded_conv": banded_conv.launches,
                    "banded_stem": banded_stem_conv.launches,
                    "banded_window_conv": banded_window_conv.launches,
                    "smem_row_gather": smem_row_gather.launches}
    finally:
        peval.InteractiveEngine.run_backbone = orig["backbone"]
        peval.InteractiveEngine.run_mask = orig["mask"]
    wall_s = time.time() - t0

    csv = os.path.join(out_dir, "val_results_multi.csv")
    rows = [r.split(" ") for r in open(csv).read().strip().split("\n") if r]
    ious = [float(r[4]) for r in rows]
    n_bb, n_mask = len(events["backbone"]), len(events["mask"])
    check(len(rows) > 0 and all(len(r) == 5 for r in rows), "no CSV rows")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in ious),
          f"IoUs not finite in [0, 1]: {ious}")
    check(isinstance(results, dict) and results and results in logged,
          "the evaluator dict was not printed")
    check(n_bb == 1 and n_mask >= 1, f"{n_bb} backbone, {n_mask} mask calls")
    check(launches["banded_conv"] == 8 * n_bb,
          f"k3 kernel launches {launches['banded_conv']} != 8 x {n_bb}")
    check(launches["banded_stem"] == 1 * n_bb,
          f"stem kernel launches {launches['banded_stem']} != {n_bb}")
    check(launches["banded_window_conv"] == launches["smem_row_gather"] == 0,
          f"a probe kernel ran on the eval path: {launches}")

    bb_first = events["backbone"][0][0].elapsed_time(events["backbone"][0][1])
    mask_ms = [s.elapsed_time(e) for s, e in events["mask"]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # steady backbone: the same batch again, after the counts were read
    engine, batch = seen["engine"], seen["batch"]
    bb_ms = time_ms(torch, lambda: engine.run_backbone(batch), reps=5,
                    warmup=1)
    pyr = batch.pyramid
    emit({"phase": "main_path", "levels": [lv.num_valid for lv in pyr.levels],
          "rows": [lv.grid.shape[0] for lv in pyr.levels],
          "csv_rows": len(rows), "backbone_calls": n_bb,
          "mask_calls": n_mask, "launches": launches,
          "backbone_first_ms": bb_first, "backbone_ms": bb_ms,
          "mask_ms_median": statistics.median(mask_ms),
          "mask_ms_first": mask_ms[0], "peak_mem_gib": peak_gib,
          "final_iou": ious[-1], "wall_s": wall_s,
          "evaluator": {k: finite(v) for k, v in results.items()}})
    return launches


def _banded_levels(pyr) -> int:
    """Levels among the two finest whose k3 convs take the kernel."""
    from agile3d_torch.models.backbone import BANDED_LEVELS, BANDED_MIN_ROWS

    return sum(lv.k3.shape[0] >= BANDED_MIN_ROWS
               for lv in pyr.levels[:BANDED_LEVELS])


def _train_clicks(torch, labels, num_obj, mc=64):
    """One click on the first voxel of every label present, per sample."""
    from agile3d_torch.models.agile3d import ClickState

    b = labels.shape[0]
    vox = np.full((b, mc), -1, np.int32)
    obj = np.zeros((b, mc), np.int32)
    for i in range(b):
        rows = [int(np.nonzero(labels[i] == o)[0][0])
                for o in range(int(num_obj[i]) + 1) if (labels[i] == o).any()]
        vox[i, :len(rows)] = rows
        obj[i, :len(rows)] = labels[i, rows]
    tm = np.tile(np.arange(mc, dtype=np.int32), (b, 1))
    return ClickState(*(torch.from_numpy(a) for a in (vox, obj, tm)))


def _cosine(a, b) -> float:
    a, b = a.double(), b.double()
    na, nb = float(a.norm()), float(b.norm())
    if nb == 0.0:
        return 1.0 if na == 0.0 else 0.0
    return float((a * b).sum()) / max(na * nb, 1e-300)


def phase_train_reference(torch, tmp):
    """One supervised step at full width from the same weights, batch,
    clicks and labels: on the CPU in plain f32, on the CPU through the
    kernels' plain versions (bf16 operands at the kernels' places), on the
    card with the kernels off (f32) and on the card with the kernels on."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.engine.train import (
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.sparse.grid import to_device

    t0 = time.time()
    cfg = Config()
    scans, lst = write_benchmark(os.path.join(tmp, "train_ref"),
                                 **TRAIN_REF_SCENES)
    ds = InterMultiObjDataset(scans, lst, cfg.model.voxel_size)
    batch, labels, num_obj, _ = prepare_batch(ds, list(range(len(ds))), cfg, 0)
    clicks = _train_clicks(torch, labels, num_obj)
    model0 = init_agile3d(cfg.model, seed=0, device="cpu")

    def run(device, banded):
        model = copy.deepcopy(model0).to(device)
        model.backbone.cfg = dataclasses.replace(model.backbone.cfg,
                                                 banded_conv=banded)
        opt, _ = make_optimizer(model, cfg, 1)
        step = make_train_step(cfg, model, opt)
        dev_batch = (to_device(batch.pyramid, device),
                     *(torch.from_numpy(a).to(device)
                       for a in (batch.feats, batch.raw, batch.sample_idx)))
        banded_conv.launches = banded_conv_dw.launches = 0
        banded_stem_conv.launches = 0
        out = step(dev_batch, type(clicks)(*(t.to(device) for t in clicks)),
                   torch.from_numpy(labels).to(device),
                   torch.from_numpy(num_obj).to(device))
        if device != "cpu":
            torch.cuda.synchronize()
        return dict(
            loss=float(out["loss"]), gnorm=float(out["gnorm"]),
            losses={k: float(v) for k, v in out["losses"].items()},
            grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            bn={n: b.detach().cpu() for n, b in model.named_buffers()
                if "running" in n},
            launches=(banded_conv.launches, banded_conv_dw.launches,
                      banded_stem_conv.launches))

    ref = run("cpu", None)
    cpu_bf16 = run("cpu", True)
    runs = {"plain": run(DEVICE, False), "kernels": run(DEVICE, True)}

    # tensors whose gradient is zero in exact arithmetic (the mask MLP's
    # output bias shifts every object's logit alike) carry only rounding
    # noise: they are held to stay at noise level, not compared
    gnorm_ref = math.sqrt(sum(float(g.norm()) ** 2
                              for g in ref["grads"].values()))
    live = [n for n, g in ref["grads"].items()
            if float(g.norm()) > 1e-6 * gnorm_ref]

    # the weights whose gradient the dW kernel computes (block8 at level 0,
    # block7 at level 1, when the level is routed): their cosine is reported
    n_lv = _banded_levels(batch.pyramid)
    layers = cfg.model.backbone.layers
    banded_weights = {f"backbone.{blk}.{i}.{conv}.kernel"
                      for blk, n_blocks in (("block8", layers[7]),
                                            ("block7", layers[6]))[:n_lv]
                      for i in range(n_blocks) for conv in ("conv1", "conv2")}

    def compare(got, ref=ref):
        loss_rel = max(abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                       for k, v in ref["losses"].items())
        cos = {n: _cosine(got["grads"][n], ref["grads"][n]) for n in live}
        flat = lambda d: torch.cat([d[n].flatten() for n in live])
        dead = max((float(g.norm()) / gnorm_ref
                    for n, g in got["grads"].items() if n not in live),
                   default=0.0)
        bn_err = max(float((got["bn"][n] - b).abs().max())
                     / (float(b.abs().max()) + 1.0)
                     for n, b in ref["bn"].items())
        worst = min(cos, key=cos.get)
        dw_cos = [c for n, c in cos.items() if n in banded_weights]
        return dict(loss=got["loss"], loss_rel=loss_rel,
                    gnorm=got["gnorm"],
                    gnorm_rel=abs(got["gnorm"] - ref["gnorm"]) / ref["gnorm"],
                    grad_cos_all=_cosine(flat(got["grads"]),
                                         flat(ref["grads"])),
                    grad_cos_min=cos[worst], grad_cos_min_at=worst,
                    grad_cos_median=statistics.median(cos.values()),
                    dw_cos_min=min(dw_cos, default=1.0),
                    dead_grad_max=dead,
                    bn_err=bn_err, launches=got["launches"])

    res = {k: compare(v) for k, v in runs.items()}
    # the kernels against their plain versions at the same places
    res["kernels_vs_cpu_bf16"] = compare(runs["kernels"], cpu_bf16)
    emit({"phase": "train_reference",
          "rows": [lv.grid.shape[0] for lv in batch.pyramid.levels],
          "num_valid": [lv.num_valid for lv in batch.pyramid.levels],
          "banded_levels": n_lv, "cpu_loss": ref["loss"],
          "cpu_gnorm": ref["gnorm"], "cpu_launches": ref["launches"],
          **{f"{k}_{m}": v for k, r in res.items() for m, v in r.items()},
          "seconds": time.time() - t0})
    check(ref["launches"] == cpu_bf16["launches"] == (0, 0, 0),
          f"CPU launches {ref['launches']}, {cpu_bf16['launches']}")
    check(res["plain"]["launches"] == (0, 0, 0),
          f"kernels off, launches {res['plain']['launches']}")
    # kernels on: forward and dX per k3 conv, dW per k3 conv, no stem
    want = (8 * n_lv, 4 * n_lv, 0)
    check(n_lv > 0 and res["kernels"]["launches"] == want,
          f"kernels on, launches {res['kernels']['launches']} != {want}")
    for k, r in res.items():
        check(math.isfinite(r["loss"]) and math.isfinite(r["gnorm"]),
              f"{k}: non-finite loss or gnorm")
        check(r["dead_grad_max"] <= 1e-5,
              f"{k}: a gradient that is zero in exact arithmetic reached "
              f"{r['dead_grad_max']} of the global norm")
    # Tolerances. At random weights the backward amplifies any rounding
    # difference (gnorm is in the hundreds), so gradients are held by
    # direction: the whole gradient's cosine and each tensor's
    # (a tensor whose gradient is a sum with heavy cancellation, such as a
    # BatchNorm bias, moves most). Each limit is about 10x the difference
    # the first full-size run on the card showed.
    # f32 on both sides, summed in other orders through 27 layers and their
    # backward
    p = res["plain"]
    check(p["loss_rel"] <= 1e-3 and p["gnorm_rel"] <= 1e-3,
          f"card f32 vs CPU f32: loss {p['loss_rel']}, gnorm {p['gnorm_rel']}")
    check(p["grad_cos_all"] >= 0.9999 and p["grad_cos_min"] >= 0.999,
          f"card f32 vs CPU f32: gradient cosine all {p['grad_cos_all']}, "
          f"min {p['grad_cos_min']} ({p['grad_cos_min_at']})")
    check(p["bn_err"] <= 1e-5, f"card f32 vs CPU f32: BN {p['bn_err']}")
    # the kernels against their plain versions at the same places (the same
    # bf16 operands): f32 sums in other orders, and now and then an operand
    # on the other side of a bf16 rounding boundary, amplified as above
    c = res["kernels_vs_cpu_bf16"]
    check(c["loss_rel"] <= 1e-2 and c["gnorm_rel"] <= 5e-2,
          f"card kernels vs CPU plain versions: loss {c['loss_rel']}, "
          f"gnorm {c['gnorm_rel']}")
    check(c["grad_cos_all"] >= 0.99 and c["grad_cos_min"] >= 0.9,
          f"card kernels vs CPU plain versions: gradient cosine all "
          f"{c['grad_cos_all']}, min {c['grad_cos_min']} "
          f"({c['grad_cos_min_at']})")
    check(c["bn_err"] <= 1e-5, f"card kernels vs CPU plain versions: BN "
                               f"{c['bn_err']}")
    # the kernels against f32: bf16 operands (8-bit mantissa) in the
    # forward, dX and dW of the routed k3 convs
    q = res["kernels"]
    check(q["loss_rel"] <= 2e-2 and q["gnorm_rel"] <= 5e-2,
          f"card kernels vs CPU f32: loss {q['loss_rel']}, gnorm "
          f"{q['gnorm_rel']}")
    check(q["grad_cos_all"] >= 0.95,
          f"card kernels vs CPU f32: gradient cosine {q['grad_cos_all']}")
    check(q["bn_err"] <= 1e-3, f"card kernels vs CPU f32: BN {q['bn_err']}")


def phase_train_main_path(torch, scans, train_list, tmp):
    """``agile3d_torch.main.main`` (in process) on synthetic ScanNet-sized
    scenes at full width: one epoch of TRAIN_STEPS steps at batch 5 and one
    validation, with the kernels' launches counted per step and the
    rollout, supervised step and backbone timed with CUDA events."""
    from agile3d_torch import main as pmain
    from agile3d_torch.engine import train as ptrain
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.row_gather import smem_row_gather
    from agile3d_torch.utils.ckpt import load_checkpoint

    with open(train_list) as f:
        first = next(iter(json.load(f).items()))
    val_list = os.path.join(tmp, "val_one.json")
    with open(val_list, "w") as f:
        json.dump(dict([first]), f)
    out_dir = os.path.join(tmp, "train_out")

    def counts():
        return (banded_conv.launches, banded_conv_dw.launches,
                banded_stem_conv.launches)

    steps, seen = [], {}
    orig_rollout, orig_make = ptrain.rollout_clicks, pmain.make_train_step

    def rollout(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.time()
        start.record()
        clicks = orig_rollout(*args, **kwargs)
        end.record()
        end.synchronize()
        steps.append({"at_rollout": counts(), "rollout": (start, end),
                      "rollout_wall_s": time.time() - t,
                      "clicks": [c.count for c in clicks]})
        return clicks

    def make_train_step(cfg, model, optimizer):
        inner = orig_make(cfg, model, optimizer)
        seen["model"] = model

        def step(device_batch, *args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner(device_batch, *args)
            end.record()
            end.synchronize()
            seen["batch"] = device_batch
            steps[-1].update(step=(start, end), at_step=counts(),
                             rows=[lv.grid.shape[0]
                                   for lv in device_batch[0].levels],
                             loss=float(out["loss"]), gnorm=float(out["gnorm"]),
                             miou=float(out["miou"]))
            return out
        return step

    args = pmain.get_args_parser().parse_args([
        "--scan_folder", scans, "--train_list", train_list,
        "--val_list", val_list, "--epochs", "1", "--val_epochs", "1",
        "--batch_size", str(TRAIN_BATCH), "--max_num_clicks", "1",
        "--seed", "0", "--output_dir", out_dir, "--device", DEVICE])
    def log(msg):
        print(f"main: {msg}", flush=True)

    ptrain.rollout_clicks, pmain.make_train_step = rollout, make_train_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        banded_conv.launches = banded_conv_dw.launches = 0
        banded_stem_conv.launches = 0
        banded_window_conv.launches = smem_row_gather.launches = 0
        hist = pmain.main(args, log=log)
        torch.cuda.synchronize()
        launches = counts()
        probe_launches = {"banded_window_conv": banded_window_conv.launches,
                          "smem_row_gather": smem_row_gather.launches}
    finally:
        ptrain.rollout_clicks, pmain.make_train_step = orig_rollout, orig_make
    wall_s = time.time() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # per step: the rollout's backbone (8 forward) before the rollout, the
    # supervised forward (8) + dX (8) and dW (8) inside the step
    prev = (0, 0, 0)
    per_step = []
    for st in steps:
        check("at_step" in st, "a rollout without a supervised step")
        per_step.append(tuple(a - b for a, b in zip(st["at_step"], prev)))
        prev = st["at_step"]
    val_launches = tuple(a - b for a, b in zip(launches, prev))
    model = seen["model"]
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    init = init_agile3d(model.cfg, seed=0, device="cpu").state_dict()
    moved = lambda pred: sum(not torch.equal(v, init[k])
                             for k, v in trained.items() if pred(k))
    n_param = moved(lambda k: "running" not in k)
    n_bn = moved(lambda k: "running" in k)
    fresh = Agile3D(model.cfg)
    load_checkpoint(os.path.join(out_dir, "checkpoint.pth"), fresh)
    ckpt_equal = all(torch.equal(fresh.state_dict()[k], v)
                     for k, v in trained.items())

    # steady backbone forward / backward on the last batch (after the
    # counts were read): training BatchNorm, a fixed random cotangent
    pyr, feats = seen["batch"][0], seen["batch"][1]
    bb = model.backbone
    fwd_ms = time_ms(torch, lambda: bb(pyr, feats, {}), reps=3, warmup=1)
    bwd = []
    for _ in range(4):
        out = bb(pyr, feats, {})[-1]
        cot = torch.randn(out.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(0), device=DEVICE)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out.backward(cot)
        end.record()
        end.synchronize()
        bwd.append(start.elapsed_time(end))
        del out, cot
    model.zero_grad(set_to_none=True)

    row = {"phase": "train_main_path", "steps": len(steps),
           "rows": [st["rows"] for st in steps],
           "clicks": [st["clicks"] for st in steps],
           "launches": {"banded_conv": launches[0],
                        "banded_conv_dw": launches[1],
                        "banded_stem": launches[2], **probe_launches},
           "launches_per_step": per_step, "launches_val": val_launches,
           "loss": [st["loss"] for st in steps],
           "gnorm": [st["gnorm"] for st in steps],
           "miou": [st["miou"] for st in steps],
           "rollout_ms": [s.elapsed_time(e)
                          for s, e in (st["rollout"] for st in steps)],
           "rollout_wall_s": [st["rollout_wall_s"] for st in steps],
           "step_ms": [s.elapsed_time(e) for s, e in (st["step"] for st in steps)],
           "backbone_fwd_ms": fwd_ms,
           "backbone_bwd_ms": statistics.median(bwd[1:]),
           "peak_mem_gib": peak_gib, "wall_s": wall_s,
           "params_moved": n_param, "bn_moved": n_bn,
           "checkpoint_loads_equal": ckpt_equal,
           "val": {k: finite(v) for k, v in hist["val"].get(0, {}).items()}}
    emit(row)
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} steps != {TRAIN_STEPS}")
    for st in steps:
        check(st["rows"][0] == 524288 and st["rows"][1] >= 32768,
              f"training batch rows {st['rows']}: not the 524,288-row bucket")
    check(all(ps == (24, 8, 0) for ps in per_step),
          f"launches per step {per_step} != (24, 8, 0)")
    check(all(v == 0 for v in probe_launches.values()),
          f"a probe kernel ran on the training path: {probe_launches}")
    check(all(math.isfinite(st["loss"]) and math.isfinite(st["gnorm"])
              for st in steps), "non-finite loss or gnorm")
    check(n_param > 0 and n_bn > 0, f"moved: {n_param} params, {n_bn} BN")
    check(ckpt_equal, "checkpoint.pth does not load back equal")
    check(hist["val"].get(0), "no validation results")
    return {"banded_conv": launches[0], "banded_conv_dw": launches[1],
            "banded_stem": launches[2], **probe_launches}


def _summary(rows, roles):
    """Sums over the rows of ``roles``, each weighted by its count."""
    mine = [r for r in rows if r["role"] in roles]
    total = lambda key: sum(r[key] * r["count"] for r in mine)
    by_ops = sum(r["bound_ms"] * r["count"] for r in mine
                 if r["bound_by"] == "operations")
    return {"max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if by_ops >= total("bound_ms") / 2
                         else "bytes"),
            "library_ms": total("library_ms"),
            "shapes": ", ".join(f"{r['count']}x {r['rows']}x{r['cin']}->"
                                f"{r['cout']} ({r['role']})" for r in mine)}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    try:
        from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
        from agile3d_torch.data.synthetic import write_benchmark
        from agile3d_torch.config import Config
        from agile3d_torch.ops import cuda_build
        from agile3d_torch.sparse.grid import to_device
    except ImportError as e:
        fail(f"the agile3d_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    phase_device(torch, cuda_build)
    with tempfile.TemporaryDirectory(prefix="agile3d_smoke_") as tmp:
        cfg = Config()
        scans, val_list = write_benchmark(os.path.join(tmp, "smoke"),
                                          **SMOKE_SCENE)
        eval_batch = collate_scenes(
            [InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)[0]],
            cfg.buckets)
        train_scans, train_list = write_benchmark(
            os.path.join(tmp, "train"), **TRAIN_SCENES)
        train_ds = InterMultiObjDataset(train_scans, train_list,
                                        cfg.model.voxel_size)
        train_batch = collate_scenes(
            [train_ds[i] for i in range(TRAIN_BATCH)], cfg.buckets)
        eval_dev = to_device(eval_batch.pyramid, DEVICE)
        shapes = phase_kernels(torch, kernel_cases(
            eval_dev, to_device(train_batch.pyramid, DEVICE)))
        probe_rows, probe_launches = phase_probes(torch, eval_batch.pyramid,
                                                  eval_dev)
        del eval_batch, eval_dev, train_batch, train_ds
        torch.cuda.empty_cache()
        phase_reference(torch, tmp)
        phase_train_reference(torch, tmp)
        eval_launches = phase_main_path(torch, scans, val_list,
                                        os.path.join(tmp, "out"))
        train_launches = phase_train_main_path(torch, train_scans, train_list,
                                               tmp)

    # launches: each path's run (counts zeroed just before, read just
    # after); the times: the training step's work for the k3 kernel and
    # dW, one eval backbone forward for the stem; for the window kernel the
    # eval backbone's eight k3 convs in banded_conv's place, for the row
    # gather the TPU probe's shape
    meta = {
        "banded_conv": ("agile3d_torch/csrc/banded_conv.cu",
                        tpu_kernel("banded_conv.py", "_make_kernel"),
                        ("train forward", "dX"), "one training step"),
        "banded_stem": ("agile3d_torch/csrc/banded_stem.cu",
                        tpu_kernel("banded_stem.py", "_make_stem_kernel"),
                        ("eval",), "one eval backbone forward"),
        "banded_conv_dw": ("agile3d_torch/csrc/banded_conv.cu",
                           tpu_kernel("banded_conv.py", "_make_dw_kernel"),
                           ("dW",), "one training step"),
        "banded_window_conv": (
            "agile3d_torch/csrc/banded_window.cu",
            tpu_kernel("probe_banded_kernel.py", "make_banded_conv"),
            ("eval shapes",),
            "one eval backbone forward's k3 convs, in banded_conv's place"),
        "smem_row_gather": (
            "agile3d_torch/csrc/row_gather.cu",
            tpu_kernel("probe_vmem_gather.py", "gather_kernel"),
            ("probe shape",), "27 x 1024 rows of a 384 x 128 f32 table"),
    }
    paths = {"probe": probe_launches, "eval": eval_launches,
             "train": train_launches}
    kernels = []
    for name, (source, replaces, roles, unit) in meta.items():
        mine = [r for r in shapes + probe_rows if r["kernel"] == name]
        summary = _summary(mine, roles)
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: summary[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
                 "per": f"{unit}: {summary['shapes']}"}
        if name == "banded_conv":
            ev = _summary(mine, ("eval",))
            entry["max_abs_err"] = max(entry["max_abs_err"], ev["max_abs_err"])
            entry["per_eval_forward"] = {k: ev[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "shapes")}
        if name == "banded_window_conv":
            entry["banded_conv_ms"] = sum(r["banded_conv_ms"] * r["count"]
                                          for r in mine)
        kernels.append(entry)
    emit({"total_s": time.time() - t_start})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
