"""A KITTI-360-scale scene on one card: counterpart of the repository's
``tools/stress_kitti.py``, on the port.

Builds the outdoor-scale synthetic scene (``make_scene(default_rng(0),
--points, 10 objects, --extent)`` plus 0.04 m of noise; 1.2M points over
22 m is the size of ``scripts/eval_multi_kitti360.sh``'s scans) and pushes
it through the backbone and the per-click decoder at full width with
seeded random weights. The voxel ladder gains two rungs beyond the
standard one, 1,572,864 and 2,097,152 rows, so that scenes past 1M voxels
pad instead of growing in 8,192-row steps. It reports:

  * the scene: voxels, the padded level-0 rows, host quantize and pyramid
    time (the native runtime);
  * the backbone: the first pass, then the median of ``--reps`` passes
    (CUDA events on the card);
  * ``forward_mask`` with 30 clicks (3 on each object): the median of
    ``--reps`` passes, the attention chunk it picked
    (``models/agile3d.py::_pick_attn_chunk``; 0 = dense);
  * memory (``utils/profiling.py::device_memory_stats``): the peak of one
    backbone pass and one decoder pass above what the process held before,
    against the oversize guard's estimate (``utils/costs.py::
    eval_hbm_gib``), and the peak over the whole run;
  * each kernel's launches in the run (B1 ``banded_conv``, B2
    ``banded_stem_conv``, the boundary distance), the backbone passes and
    the levels whose k3 convs take B1 (``models/backbone.py``'s rule).

``--skip_backbone`` fabricates the decoder's scene features (random mask
features, the real positional encoding). ``--sp N`` also runs the
voxel-sharded decoder (``parallel/sp.py``) on N spawned ranks and holds
its masks against the one-process pass (JAX's band, 2e-3): on ``nccl``
with one card a rank where the machine has N cards, else on ``gloo``
(ranks sharing the one card, or the CPU): function, not scaling.
``--sp_only`` skips the single-process timings. The JAX tool's ``--cpu``
(a virtual 8-device XLA CPU mesh) and ``--quick`` (one compile draw) are
XLA mechanics and have no counterpart; its dispatch-extrapolated timing
loops are CUDA-event medians here, and its SP scan-against-host-loop
rollout timing is not ported (the port's rollouts have no compile
dispatch to amortise).

    python -m agile3d_torch.tools.stress_kitti [--points 1200000]
        [--extent 22] [--decoder_dtype float32|bfloat16] [--reps 5]
        [--skip_backbone] [--sp N [--sp_only]] [--device cpu]

It runs on the card unless ``--device cpu`` is given; the last line of its
output is one JSON object with every number it reports.
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

from agile3d_torch.config import DEFAULT_VOXEL_BUCKETS, Config
from agile3d_torch.data.datasets import SceneSample, collate_scenes
from agile3d_torch.data.synthetic import make_scene
from agile3d_torch.models.backbone import BANDED_LEVELS, BANDED_MIN_ROWS
from agile3d_torch.sparse.quantize import sparse_quantize
from agile3d_torch.tools import device_label, resolve_device, time_ms

# two rungs beyond the standard ladder: >= 1.5M-voxel scenes pad to them
STRESS_BUCKETS = tuple(DEFAULT_VOXEL_BUCKETS) + (1572864, 2097152)
NUM_OBJ = 10
NOISE = 0.04
CLICKS_PER_OBJ = 3
SP_BAND = 2e-3


def stress_config(decoder_dtype: str = "float32") -> Config:
    cfg = Config(buckets=STRESS_BUCKETS)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, decoder_dtype=decoder_dtype))


def stress_scene(points: int, extent: float):
    """(coords, colors, labels, rng): the JAX tool's scene, with the
    generator left where it is for the clicks."""
    rng = np.random.default_rng(0)
    coords, colors, labels = make_scene(rng, n_points=points,
                                        num_obj=NUM_OBJ, extent=extent)
    coords += rng.standard_normal(coords.shape).astype(np.float32) * NOISE
    return coords, colors, labels, rng


def host_prep(coords, colors, labels, cfg: Config):
    """The one-scene batch as the JAX tool builds it: quantized at the
    model's voxel size and collated on ``cfg.buckets``. Returns (batch,
    voxels, padded level-0 rows)."""
    vox, umap, imap = sparse_quantize(coords, cfg.model.voxel_size)
    sample = SceneSample(
        vox_coords=vox, raw_coords=coords[umap],
        feats=colors[umap].astype(np.float32) / 255.0,
        labels=labels[umap].astype(np.int32),
        labels_full=labels.astype(np.int32), inverse_map=imap,
        click_idx={}, scene_name="kitti_stress", num_obj=NUM_OBJ)
    batch = collate_scenes([sample], cfg.buckets)
    return batch, len(vox), batch.pyramid.levels[0].grid.shape[0]


def click_table(rng, n_valid: int, cfg: Config, mc: int):
    """The JAX tool's mid-session clicks: 30 random voxels, each object
    three times in turn, times in order; as a [1, mc] table."""
    from agile3d_torch.engine.clicks import HostClicks, NewClicks

    n = NUM_OBJ * CLICKS_PER_OBJ
    clicks = HostClicks(cfg.model.max_clicks)
    clicks.extend(NewClicks(rng.integers(0, n_valid, n).astype(np.int32),
                            np.tile(np.arange(NUM_OBJ, dtype=np.int32) + 1,
                                    CLICKS_PER_OBJ),
                            np.arange(n, dtype=np.int32)))
    return clicks


def decoder_chunk(n_pad: int, clicks_bucket: int, cfg: Config) -> int:
    """The chunk ``forward_mask`` picks for one scene of ``n_pad`` rows and
    a click table of ``clicks_bucket`` slots (0 = dense)."""
    from agile3d_torch.models.agile3d import _pick_attn_chunk

    q = cfg.model.num_bg_queries + clicks_bucket
    return _pick_attn_chunk(n_pad, q * n_pad * cfg.model.num_heads,
                            cfg.model)


def fabricated_scene(model, batch, n_valid: int, device):
    """Scene features without the backbone: random mask features (seed 1,
    x0.5), the real positional encoding of the raw coordinates."""
    from agile3d_torch.models.agile3d import SceneFeatures

    cfg = model.cfg
    n_pad = batch.raw.shape[0]
    raw = torch.from_numpy(batch.raw).to(device)[None]
    valid = torch.zeros((1, n_pad), dtype=torch.bool, device=device)
    valid[0, :n_valid] = True
    feat = np.random.default_rng(1).standard_normal(
        (n_pad, cfg.hidden_dim)).astype(np.float32) * 0.5
    feat[n_valid:] = 0
    cmin = raw[0, :n_valid].amin(0)[None]
    cmax = raw[0, :n_valid].amax(0)[None]
    with torch.no_grad():
        pos = model._pos(raw, cmin[:, None, :], cmax[:, None, :],
                         model.pos_enc.gauss_B)
    pos = torch.where(valid[..., None], pos, torch.zeros((), device=device))
    feat = torch.from_numpy(feat).to(device)[None]
    if cfg.decoder_dtype == "bfloat16":   # as forward_backbone gives them
        feat, pos = feat.to(torch.bfloat16), pos.to(torch.bfloat16)
    return SceneFeatures(mask_feat=feat, pos_pcd=pos, vox_valid=valid,
                         raw=raw, cmin=cmin, cmax=cmax)


def _sp_rank(path: str, device: str, decoder_dtype: str) -> dict:
    """One rank of the sharded decoder: this rank's rows of the saved scene
    through ``make_forward_mask_sp``, against the one-process masks saved
    beside them; the counts summed over the ranks."""
    from agile3d_torch.models.agile3d import (
        ClickState,
        SceneFeatures,
        init_agile3d,
    )
    from agile3d_torch.parallel.mesh import make_mesh, psum
    from agile3d_torch.parallel.sp import make_forward_mask_sp, shard_rows

    mesh = make_mesh(n_dp=1, n_sp=torch.distributed.get_world_size(),
                     device=device)
    dev = mesh.device
    cfg = stress_config(decoder_dtype)
    saved = torch.load(path, map_location="cpu", weights_only=False)
    model = init_agile3d(cfg.model, seed=0, device=dev)
    fm_sp, shard = make_forward_mask_sp(mesh, cfg.model)
    axis = mesh["sp"]
    scene = shard(SceneFeatures(*(t.to(dev) for t in saved["scene"])))
    clicks = ClickState(*(t.to(dev) for t in saved["clicks"]))
    num_obj = saved["num_obj"].to(dev)
    with torch.no_grad():
        fm_sp(model, scene, clicks, num_obj)      # warm
        t0 = time.perf_counter()
        got = fm_sp(model, scene, clicks, num_obj)["pred_masks"][0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
    want = shard_rows(saved["pred_masks"], axis, 0).to(dev)
    valid = scene.vox_valid[0]
    diff = (got - want).abs()[valid]
    excess = float((diff / (SP_BAND + SP_BAND * want.abs()[valid])).max())
    equal = got.argmax(-1)[valid] == want.argmax(-1)[valid]
    counts = psum(torch.tensor([float(equal.sum()), float(equal.numel())],
                               device=dev), axis)
    return {"rows_per_rank": int(scene.mask_feat.shape[1]),
            "max_abs_diff": float(diff.max()) if diff.numel() else 0.0,
            "band_ratio": excess, "ms": ms,
            "argmax_agreement": float(counts[0] / counts[1])}


def run_sp(sp: int, scene, clicks, num_obj, pred_masks, device,
           decoder_dtype: str) -> dict:
    """The sharded decoder on ``sp`` spawned ranks against ``pred_masks``
    [N, C] (the one-process pass)."""
    from agile3d_torch.parallel.mesh import spawn

    on_cards = device.type == "cuda" and torch.cuda.device_count() >= sp
    backend = "nccl" if on_cards else "gloo"
    with tempfile.TemporaryDirectory(prefix="stress_sp_") as tmp:
        path = os.path.join(tmp, "scene.pt")
        torch.save({"scene": tuple(t.cpu() for t in scene),
                    "clicks": tuple(t.cpu() for t in clicks),
                    "num_obj": num_obj.cpu(),
                    "pred_masks": pred_masks.cpu()}, path)
        ranks = spawn(_sp_rank, sp, path, str(device), decoder_dtype,
                      device=str(device), backend=backend)
    return {"sp": sp, "backend": backend, "ranks": ranks,
            "argmax_agreement": ranks[0]["argmax_agreement"],
            "band_ratio": max(r["band_ratio"] for r in ranks),
            "within_band": all(r["band_ratio"] <= 1.0 for r in ranks)}


def _peak(device) -> int:
    from agile3d_torch.utils.profiling import device_memory_stats

    idx = torch.cuda.current_device() if device.index is None else device.index
    return device_memory_stats()[f"cuda:{idx}"]["peak_bytes_in_use"]


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("KITTI-360-scale stress (PyTorch)")
    ap.add_argument("--points", type=int, default=1_200_000)
    ap.add_argument("--extent", type=float, default=22.0)
    ap.add_argument("--sp", type=int, default=1,
                    help="also run the voxel-sharded decoder on this many "
                         "spawned ranks and hold it against one process")
    ap.add_argument("--skip_backbone", action="store_true",
                    help="decoder only, on fabricated scene features")
    ap.add_argument("--sp_only", action="store_true",
                    help="skip the single-process timings (needs --sp > 1)")
    ap.add_argument("--decoder_dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--reps", type=int, default=5,
                    help="timed passes of the backbone and of the decoder")
    ap.add_argument("--device", default="",
                    help="'' or 'cuda' (default): the card; 'cpu'")
    return ap


def run(args, log=print) -> dict:
    """The stress run of ``args`` (``get_args_parser``'s); returns the
    result that the last line prints."""
    from agile3d_torch.engine.eval import InteractiveEngine, stack_clicks
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.utils.costs import eval_hbm_gib
    from agile3d_torch.utils.profiling import kernel_launches

    if args.sp_only and args.sp <= 1:
        raise SystemExit("--sp_only times nothing and checks nothing "
                         "without an SP branch; pass --sp > 1")
    device = resolve_device(args.device or "cuda")
    on_card = device.type == "cuda"
    cfg = stress_config(args.decoder_dtype)
    res = {"device": device_label(device), "points": args.points,
           "extent": args.extent, "decoder_dtype": args.decoder_dtype}
    coords, colors, labels, rng = stress_scene(args.points, args.extent)
    t0 = time.perf_counter()
    batch, n_valid, n_pad = host_prep(coords, colors, labels, cfg)
    res.update(voxels=n_valid, rows=n_pad,
               host_prep_s=time.perf_counter() - t0,
               banded_levels=sum(
                   lv.k3.shape[0] >= BANDED_MIN_ROWS
                   for lv in batch.pyramid.levels[:BANDED_LEVELS]))
    log(f"scene: {n_valid} voxels (padded {n_pad}); host quantize+pyramid "
        f"{res['host_prep_s']:.2f}s")

    launches0 = kernel_launches()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device) if on_card else 0
    model = init_agile3d(cfg.model, seed=0, device=device)
    engine = InteractiveEngine(cfg, model, device)
    clicks = click_table(rng, n_valid, cfg, cfg.model.max_clicks)
    mc = engine._click_bucket(clicks.count)
    cs = stack_clicks([clicks], mc, device)
    num_obj = torch.tensor([NUM_OBJ], dtype=torch.int32, device=device)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)

    t0 = time.perf_counter()
    if args.skip_backbone:
        scene = fabricated_scene(model, batch, n_valid, device)
    else:
        scene = engine.run_backbone(batch)
    sync()
    res["backbone_first_s"] = time.perf_counter() - t0
    with torch.no_grad():
        out = model.forward_mask(scene, cs, num_obj)
        pred_masks = out["pred_masks"][0]
    sync()
    res.update(chunk=out["attn_chunk"],
               chunk_rule=decoder_chunk(n_pad, mc, cfg), clicks=clicks.count,
               click_bucket=mc, finite=bool(torch.isfinite(
                   pred_masks[:n_valid, :NUM_OBJ + 1]).all()))
    del out
    if on_card:
        peak = _peak(device)
        res.update(footprint_gib=(peak - before) / 2 ** 30,
                   estimate_gib=eval_hbm_gib(n_pad),
                   footprint_bytes_per_row=(peak - before) / n_pad)
    log(f"backbone + one decoder pass: chunk {res['chunk']} "
        f"({'chunked' if res['chunk'] else 'dense'}), finite "
        f"{res['finite']}"
        + (f", footprint {res['footprint_gib']:.2f} GiB against the "
           f"guard's {res['estimate_gib']:.2f}" if on_card else ""))

    passes = [0 if args.skip_backbone else 1]
    if not args.sp_only:
        if not args.skip_backbone:
            def backbone():
                engine.run_backbone(batch)
                passes[0] += 1

            res["backbone_ms"] = time_ms(backbone, device, reps=args.reps,
                                         warmup=1)
        with torch.no_grad():
            res["forward_mask_ms"] = time_ms(
                lambda: model.forward_mask(scene, cs, num_obj), device,
                reps=args.reps, warmup=1)
        log(f"backbone {res.get('backbone_ms', float('nan')):.1f} ms, "
            f"forward_mask {res['forward_mask_ms']:.1f} ms a click "
            f"(median of {args.reps}; {res['device']})")
    if on_card:
        sync()
        res["run_peak_gib"] = _peak(device) / 2 ** 30
        res["card_gib"] = torch.cuda.get_device_properties(
            device).total_memory / 2 ** 30
    res["backbone_passes"] = passes[0]
    res["launches"] = {k: v - launches0[k]
                       for k, v in kernel_launches().items()}
    if args.sp > 1:
        res["sp"] = run_sp(args.sp, scene, cs, num_obj, pred_masks, device,
                           args.decoder_dtype)
        log(f"SP decoder (sp={args.sp}, {res['sp']['backend']}): argmax "
            f"agreement {res['sp']['argmax_agreement']:.6f}, largest "
            f"difference {res['sp']['band_ratio']:.3f} of the band")
    log(json.dumps(res, sort_keys=True))
    return res


def main(argv=None) -> dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
