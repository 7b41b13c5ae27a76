#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agile3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  -- the card, its power limit, and the build of the CUDA kernels
                from ``agile3d_torch/csrc`` (one nvcc per source, all at once);
  2. kernels -- each kernel at the main path's shapes (the smoke scene's own
                neighbour maps) against its plain PyTorch version on the
                card, with times from CUDA events (median of 10 after
                warm-up) for the kernel, the plain version and a library
                yardstick (one bf16 gather and one cuBLAS matmul, timed here
                only), beside the card's least time for the same work;
  3. reference -- the full-width model on a mid-size scene on the card
                (kernels on, then off) against the same model on the CPU,
                the plain float32 path that the CPU tests hold against the
                JAX package;
  4. main path -- ``python -m agile3d_torch.eval_multi_obj`` (in process) on
                the synthetic smoke scene (400,000 points, 8 objects) at full
                Res16UNet34C width with seeded random weights, 2 clicks per
                object, with the kernels' launch counts read around it.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SMOKE_SCENE = dict(num_scenes=1, num_obj=8, n_points=400000, extent=8.0, seed=0)
REF_SCENE = dict(num_scenes=1, num_obj=4, n_points=60000, extent=4.0, seed=1)
MAX_NUM_CLICKS = 2
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
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    port (read as text; nothing of that package is imported)."""
    port = os.path.join(ROOT, "agile3d_torch")
    for path in sorted(glob.glob(os.path.join(ROOT, "*", "ops", module))):
        if path.startswith(port + os.sep):
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if line.startswith(f"def {func}("):
                    return f"{os.path.relpath(path, ROOT)}:{i}"
    fail(f"no definition of {func} in ops/{module} of the JAX package")


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
                        if "registers" in ln or "spill" in ln]
                    for k, v in reports.items()}})


def phase_kernels(torch, pyr):
    """Kernel vs plain version on the card at the main path's shapes."""
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_reference
    from agile3d_torch.ops.banded_stem import (
        banded_stem_conv,
        banded_stem_conv_reference,
    )

    g = torch.Generator(device=DEVICE).manual_seed(0)
    lv0, lv1 = pyr.levels[0], pyr.levels[1]
    # per backbone forward: at each of the two finest levels the first block
    # of block8 / block7 takes 128 -> 96 and the other three k3 convs 96 -> 96
    cases = [("banded_conv", lv, cin, 96, per, banded_conv,
              banded_conv_reference)
             for lv in (lv0, lv1) for cin, per in ((128, 1), (96, 3))]
    cases.append(("banded_stem", lv0, 3, 32, 1, banded_stem_conv,
                  banded_stem_conv_reference))
    rows = []
    for name, lv, cin, cout, per, kern, plain in cases:
        nbr = lv.k5 if name == "banded_stem" else lv.k3
        n, k = nbr.shape
        x = torch.randn((n, cin), generator=g, device=DEVICE)
        x[lv.num_valid:] = 0.0
        w = torch.randn((k, cin, cout), generator=g, device=DEVICE) \
            * (k * cin) ** -0.5
        y = kern(x, nbr, w)
        ref = plain(x, nbr, w)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        ref_max = float(ref.abs().max())
        tol = 1e-3 * (ref_max + 1.0)
        pad_max = float(y[lv.num_valid:].abs().max()) if n > lv.num_valid else 0.0
        check(bool(torch.isfinite(y).all()), f"{name} {n}x{cin}->{cout}: non-finite")
        check(err <= tol, f"{name} {n}x{cin}->{cout}: max|kernel - plain| "
                          f"{err} > {tol}")
        check(pad_max == 0.0, f"{name} {n}x{cin}->{cout}: pad rows {pad_max}")

        # yardstick: one bf16 row gather (-1 picks the appended zero row) and
        # one cuBLAS matmul over [n, k*cin]
        xz = torch.cat([x, x.new_zeros((1, cin))]).to(torch.bfloat16)
        idx = nbr.long()
        w2 = w.to(torch.bfloat16).reshape(k * cin, cout)
        lib = time_ms(torch, lambda: torch.matmul(xz[idx].view(n, k * cin), w2))
        b_ms, b_by = bound(nbr, cin, cout)
        row = dict(kernel=name, rows=n, cin=cin, cout=cout, per_forward=per,
                   num_valid=lv.num_valid, max_abs_err=err, ref_max=ref_max,
                   tol=tol, rel_err=err / max(ref_max, 1e-30),
                   ms=time_ms(torch, lambda: kern(x, nbr, w)),
                   plain_ms=time_ms(torch, lambda: plain(x, nbr, w)),
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_parity", **row})
        rows.append(row)
        del x, w, y, ref, xz, idx, w2
        torch.cuda.empty_cache()
    return rows


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
        results = eval_multi_obj.main(args, log=log)
        torch.cuda.synchronize()
        launches = {"banded_conv": banded_conv.launches,
                    "banded_stem": banded_stem_conv.launches}
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
        scans, val_list = write_benchmark(os.path.join(tmp, "smoke"),
                                          **SMOKE_SCENE)
        cfg = Config()
        batch = collate_scenes(
            [InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)[0]],
            cfg.buckets)
        pyr = to_device(batch.pyramid, DEVICE)
        shapes = phase_kernels(torch, pyr)
        del pyr
        torch.cuda.empty_cache()
        phase_reference(torch, tmp)
        launches = phase_main_path(torch, scans, val_list,
                                   os.path.join(tmp, "out"))

    kernels = []
    meta = {
        "banded_conv": ("agile3d_torch/csrc/banded_conv.cu",
                        tpu_kernel("banded_conv.py", "_make_kernel")),
        "banded_stem": ("agile3d_torch/csrc/banded_stem.cu",
                        tpu_kernel("banded_stem.py", "_make_stem_kernel")),
    }
    for name, (source, replaces) in meta.items():
        mine = [r for r in shapes if r["kernel"] == name]
        total = lambda key: sum(r[key] * r["per_forward"] for r in mine)
        by_ops = sum(r["bound_ms"] * r["per_forward"] for r in mine
                     if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if by_ops >= total("bound_ms") / 2
                         else "bytes"),
            "library_ms": total("library_ms"),
            "per": "one backbone forward: " + ", ".join(
                f"{r['per_forward']}x {r['rows']}x{r['cin']}->{r['cout']}"
                for r in mine)})
    emit({"total_s": time.time() - t_start})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
