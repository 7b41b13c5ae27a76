"""Per-rank memory of the voxel-sharded backbone against one process:
counterpart of the repository's ``tools/measure_sp_hbm.py``, on the port.

Builds the JAX tool's scene (``make_scene(default_rng(0), --points, 10
objects, --extent)`` plus 0.04 m of noise; 4M points over 60 m pad to
2,162,688 rows on the stress ladder, ``Config(buckets=DEFAULT_VOXEL_BUCKETS
+ (1572864, 2097152))``) and seeded random full-width Res16UNet34C weights,
then measures what one participant holds for the eval backbone:

  * one process: ``models/agile3d.py::Agile3D.forward_backbone`` in eval,
    in this process, before any rank starts;
  * ``--sp`` ranks: ``parallel/sp_backbone.py`` (``partition_pyramid`` here
    once, then in each spawned rank ``local_pyramid`` and
    ``make_forward_backbone_sp``), each rank holding its block of rows and
    the halo.

The JAX tool compiles both programs and reads XLA's memory analysis
(temp + arguments + output per device) without running them. Torch has no
such analysis, so here both are run. Each process resets its allocator's
peak once CUDA is up and before anything is uploaded, then uploads the
weights, the features and the maps and runs one forward; its reading is
the peak of ``peak_bytes_in_use`` (``utils/profiling.py::
device_memory_stats``) over that, above what the process held before
(nothing, in the tool's own processes): the arguments, the temporaries and
the output in the caching allocator's terms (the CUDA context is not in
it).
Every rank has its own allocator, so a rank's peak is its own even where
the ranks share one card. This process frees its cached blocks before the
ranks spawn.

The one-process pass launches the banded kernels as the eval backbone
does (B1 on the two finest levels, B2 for the stem); the sharded backbone
runs the plain convs, as the JAX package's does, and launches neither.
Each count is printed. The ranks run on ``nccl``, one card a rank, where
the machine has ``--sp`` cards, else on ``gloo`` (ranks sharing the one
card, or the CPU): a rank's memory is what one participant of an
``--sp``-wide slice holds; the wall times are not scaling.

    python -m agile3d_torch.tools.measure_sp_hbm [--points 4000000]
        [--extent 60] [--sp 8] [--device cpu]

It runs on the card unless ``--device cpu`` is given; on the CPU the
memory fields are null. The last line of its output is one JSON object
with every number it reports.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from agile3d_torch.tools import device_label, rank_backend, resolve_device
from agile3d_torch.tools.stress_kitti import host_prep, stress_config, stress_scene

# the sharded scene features against the one-process plain pass: the
# voxel-sharded backbone's bounds (tests/test_torch_parallel_backbone.py)
FEATURE_TOL = {"mask_feat": 2e-4, "pos_pcd": 1e-5, "cmin": 1e-6,
               "cmax": 1e-6}
FEATURES = tuple(FEATURE_TOL)


def fmt(b) -> str:
    return "not measured (cpu)" if b is None else f"{b / 2**30:.2f} GiB"


def _memory(device) -> dict:
    from agile3d_torch.utils.profiling import device_memory_stats

    torch.cuda.synchronize(device)
    idx = torch.cuda.current_device() if device.index is None else device.index
    return device_memory_stats()[f"cuda:{idx}"]


def _start_peak(device) -> int:
    """CUDA up, nothing cached, the peak reset: the reading starts here.
    Returns the bytes that the process holds already (0 in the tool's
    own processes; a caller's tensors when it runs in a larger one)."""
    if device.type != "cuda":
        return 0
    torch.cuda.init()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return _memory(device)["bytes_in_use"]


def _read_peak(device, base: int) -> int | None:
    """The peak in use since ``_start_peak``, above its ``base``."""
    if device.type != "cuda":
        return None
    return _memory(device)["peak_bytes_in_use"] - base


def _launches_since(before: dict) -> dict:
    from agile3d_torch.utils.profiling import kernel_launches

    return {k: v - before[k] for k, v in kernel_launches().items()}


def _features(scene, rows: int) -> dict:
    """The scene features of one scene as host arrays: [rows, C] for the
    per-row fields, [3] for cmin / cmax."""
    return {"mask_feat": scene.mask_feat[0, :rows].float().cpu().numpy(),
            "pos_pcd": scene.pos_pcd[0, :rows].float().cpu().numpy(),
            "cmin": scene.cmin[0].cpu().numpy(),
            "cmax": scene.cmax[0].cpu().numpy()}


def single_process(batch, cfg, device, keep_plain: bool = False) -> dict:
    """The eval backbone in this process: the peak over the upload and one
    forward, its wall time and launches. ``keep_plain`` also returns the
    scene features of the plain convs (a second pass with the banded
    kernels off, after the reading), the sharded backbone's arithmetic."""
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.sparse.grid import to_device
    from agile3d_torch.utils.profiling import kernel_launches

    n_pad = batch.pyramid.levels[0].grid.shape[0]
    base = _start_peak(device)
    before = kernel_launches()
    t0 = time.perf_counter()
    model = init_agile3d(cfg.model, seed=0, device=device)
    inputs = (to_device(batch.pyramid, device),
              *(torch.from_numpy(a).to(device)
                for a in (batch.feats, batch.raw, batch.sample_idx)))
    with torch.no_grad():
        scene = model.forward_backbone(*inputs)
    peak = _read_peak(device, base)
    out = {"peak_bytes": peak, "wall_s": time.perf_counter() - t0,
           "launches": _launches_since(before)}
    if keep_plain:
        # the kernels touch the backbone's maps only: pos_pcd, cmin and
        # cmax come out of the raw coordinates alike in both passes
        out["kernel_features"] = {
            "mask_feat": _features(scene, n_pad)["mask_feat"]}
        if any(out["launches"].values()):
            del scene
            model.backbone.cfg = dataclasses.replace(model.backbone.cfg,
                                                     banded_conv=False)
            with torch.no_grad():
                scene = model.forward_backbone(*inputs)
        out["plain_features"] = _features(scene, n_pad)
    del model, inputs, scene
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return out


def _save_rank_inputs(path: str, sp_pyr, batch, reference) -> None:
    """Every array a rank reads, one ``.npy`` each, so that a rank maps
    its block of rows and never the whole scene."""
    for l, lvl in enumerate(sp_pyr.levels):
        for name, a in lvl._asdict().items():
            if a is not None:
                np.save(os.path.join(path, f"lv{l}_{name}.npy"), a)
    np.save(os.path.join(path, "feats.npy"), batch.feats)
    np.save(os.path.join(path, "raw.npy"), batch.raw)
    for kind, feats in (reference or {}).items():
        for name, a in feats.items():
            np.save(os.path.join(path, f"{kind}_{name}.npy"), a)


def _load(path: str, name: str):
    f = os.path.join(path, f"{name}.npy")
    return np.load(f, mmap_mode="c") if os.path.exists(f) else None


def _sp_rank(path: str, n_levels: int, device: str, compare: bool) -> dict:
    """One rank of the sharded backbone: its peak over the upload of the
    weights, its rows' maps and features and one forward; with
    ``compare``, its rows of the scene features against the one-process
    passes saved beside the maps."""
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.parallel.mesh import make_mesh
    from agile3d_torch.parallel.sp_backbone import (
        SPLevel,
        SPPyramid,
        local_pyramid,
        make_forward_backbone_sp,
    )
    from agile3d_torch.utils.profiling import kernel_launches

    mesh = make_mesh(n_dp=1, n_sp=torch.distributed.get_world_size(),
                     device=device)
    dev, axis = mesh.device, mesh["sp"]
    cfg = stress_config()
    sp_pyr = SPPyramid(tuple(
        SPLevel(**{f: _load(path, f"lv{l}_{f}") for f in SPLevel._fields})
        for l in range(n_levels)))
    base = _start_peak(dev)
    before = kernel_launches()
    t0 = time.perf_counter()
    model = init_agile3d(cfg.model, seed=0, device=dev)
    lv = local_pyramid(sp_pyr, axis, dev)
    rows = lv[0].valid.shape[0]
    lo = axis.index * rows
    block = lambda name: torch.from_numpy(np.ascontiguousarray(
        _load(path, name)[lo:lo + rows])).to(dev)
    scene = make_forward_backbone_sp(mesh, cfg.model)(
        model, lv, block("feats"), block("raw"))
    peak = _read_peak(dev, base)
    out = {"rank": axis.index, "rows": rows,
           "halo_rows": int(lv[0].halo_src.shape[0]),
           "peak_bytes": peak, "wall_s": time.perf_counter() - t0,
           "launches": _launches_since(before)}
    if compare:
        got = _features(scene, rows)
        for kind in ("plain", "kernel"):
            diff = {}
            for name in FEATURES:
                want = _load(path, f"{kind}_{name}")
                if want is None:
                    continue
                if got[name].ndim == 2:
                    want = want[lo:lo + rows]
                diff[name] = float(np.abs(got[name] - want).max())
            out[f"{kind}_max_abs_diff"] = diff
    return out


def run_sp(sp: int, sp_pyr, batch, device, reference=None) -> dict:
    """The sharded backbone on ``sp`` spawned ranks: each rank's reading
    (rank order) and the backend."""
    from agile3d_torch.parallel.mesh import spawn

    backend = rank_backend(device, sp)
    with tempfile.TemporaryDirectory(prefix="sp_hbm_") as tmp:
        _save_rank_inputs(tmp, sp_pyr, batch, reference)
        ranks = spawn(_sp_rank, sp, tmp, len(sp_pyr.levels), str(device),
                      reference is not None, device=str(device),
                      backend=backend)
    return {"backend": backend, "ranks": ranks}


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "per-rank memory of the voxel-sharded backbone (PyTorch)")
    ap.add_argument("--points", type=int, default=4_000_000)
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--sp", type=int, default=8)
    ap.add_argument("--device", default="",
                    help="'' or 'cuda' (default): the card; 'cpu'")
    return ap


def run(args, log=print, compare: bool = False) -> dict:
    """The measurement of ``args`` (``get_args_parser``'s); returns the
    result that the last line prints. ``compare`` also holds each rank's
    rows of the scene features against the one-process pass: against
    its plain convs within ``FEATURE_TOL`` (``within_tol``), and the
    mask features against the pass with the banded kernels (their bf16
    operands), reported beside the largest plain ``mask_feat``."""
    from agile3d_torch.parallel.sp_backbone import partition_pyramid

    if args.sp < 2:
        raise SystemExit(f"--sp must be >= 2, got {args.sp}")
    device = resolve_device(args.device or "cuda")
    cfg = stress_config()
    res = {"device": device_label(device), "points": args.points,
           "extent": args.extent, "sp": args.sp}
    coords, colors, labels, _ = stress_scene(args.points, args.extent)
    t0 = time.perf_counter()
    batch, n_valid, n_pad = host_prep(coords, colors, labels, cfg)
    res.update(voxels=n_valid, rows=n_pad,
               host_prep_s=time.perf_counter() - t0)
    log(f"scene: {n_valid} voxels (padded {n_pad}); host prep "
        f"{res['host_prep_s']:.1f}s")

    single = single_process(batch, cfg, device, keep_plain=compare)
    res["single"] = {k: single[k] for k in ("peak_bytes", "wall_s",
                                            "launches")}
    log(f"single-process backbone: {fmt(single['peak_bytes'])} peak in use "
        f"(weights + features + maps + one forward) in "
        f"{single['wall_s']:.1f}s; kernel launches "
        f"{ {k: v for k, v in single['launches'].items() if v} }")

    t0 = time.perf_counter()
    sp_pyr = partition_pyramid(batch.pyramid, args.sp)
    h0 = sp_pyr.levels[0].halo_src.reshape(args.sp, -1).shape[1]
    res.update(partition_s=time.perf_counter() - t0, halo0_rows=h0,
               halo0_live=int((sp_pyr.levels[0].halo_src >= 0).sum()),
               halo0_share=h0 / n_pad)
    log(f"partition {res['partition_s']:.1f}s; level-0 halo {h0} rows "
        f"({100 * h0 / n_pad:.1f}% of N)")

    reference = None
    if compare:
        reference = {"plain": single.pop("plain_features"),
                     "kernel": single.pop("kernel_features")}
        res["mask_feat_scale"] = float(
            np.abs(reference["plain"]["mask_feat"]).max())
    t0 = time.perf_counter()
    sp = run_sp(args.sp, sp_pyr, batch, device, reference)
    del reference, single
    ranks = sp["ranks"]
    peaks = [r["peak_bytes"] for r in ranks]
    sp_peak = None if None in peaks else max(peaks)
    res["sp_ranks"] = {"backend": sp["backend"],
                       "wall_s": time.perf_counter() - t0,
                       "peak_bytes": peaks, "peak_bytes_max": sp_peak,
                       "rows": [r["rows"] for r in ranks],
                       "halo_rows": [r["halo_rows"] for r in ranks],
                       "forward_wall_s": [r["wall_s"] for r in ranks],
                       "launches": {k: sum(r["launches"][k] for r in ranks)
                                    for k in ranks[0]["launches"]}}
    log(f"sp={args.sp} backbone: {fmt(sp_peak)} peak in use per rank (the "
        f"largest of {args.sp}, {sp['backend']}); kernel launches "
        f"{ {k: v for k, v in res['sp_ranks']['launches'].items() if v} }")
    single_peak = res["single"]["peak_bytes"]
    res["reduction"] = (None if sp_peak is None
                        else single_peak / max(sp_peak, 1))
    log(f"per-rank reduction: "
        + ("not measured (cpu)" if res["reduction"] is None else
           f"{res['reduction']:.2f}x ({fmt(single_peak)} -> {fmt(sp_peak)})"))
    if compare:
        for kind in ("plain", "kernel"):
            res[f"{kind}_max_abs_diff"] = {
                name: max(r[f"{kind}_max_abs_diff"][name] for r in ranks)
                for name in ranks[0][f"{kind}_max_abs_diff"]}
        res["within_tol"] = all(res["plain_max_abs_diff"][k] <= tol
                                for k, tol in FEATURE_TOL.items())
    log(json.dumps(res, sort_keys=True))
    return res


def main(argv=None) -> dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
