"""Per-click latency benchmark: ``python -m agile3d_torch.bench``.

The port's counterpart of the JAX package's root ``bench.py``: the p50
device time of one ``forward_mask`` (one click round with the scene's
backbone features cached) on a ScanNet-scale synthetic scene, at f32 and
at the serving dtype (bf16), beside the backbone's time and the model's
operation and byte counts (``utils/costs.py``). The last line printed is
one JSON object with ``bench.py``'s keys: ``metric``, ``value`` (ms),
``unit``, ``vs_baseline`` (50 / p50: above 1 is under the 50 ms
per-click limit), ``raw`` and ``roofline``.

Times: on the card, CUDA events around each call, each call queued behind
a short spin kernel so that the host's launch of it is hidden
(``tools.time_ms``); the median of ``--reps`` calls after ``--warmup``.
``--device cpu`` runs the plain versions on the CPU, with host-clock
times that are not the card's. The TPU bench's draw and extrapolation
machinery (compile draws, the salt, two loop lengths) answers a remote TPU
compile service and is not carried over.

    python -m agile3d_torch.bench [--device cpu] [--n_points N] [--out F]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import SceneSample, collate_scenes
from agile3d_torch.data.synthetic import make_scene
from agile3d_torch.engine.clicks import HostClicks, NewClicks
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    resolve_device,
    stack_clicks,
)
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.ops.banded_conv import banded_conv
from agile3d_torch.ops.banded_stem import banded_stem_conv
from agile3d_torch.sparse.quantize import sparse_quantize
from agile3d_torch.tools import device_label, time_ms, wall_ms
from agile3d_torch.utils.costs import (
    backbone_costs,
    decoder_costs,
    stage_table,
    summarize,
)

LIMIT_MS = 50.0
NUM_OBJ = 8
NUM_CLICKS = 24


def noisy_scene(rng, n_points: int, num_obj: int, extent: float):
    """A synthetic room (``make_scene``) with 0.03 m of noise:
    (coords, colors, labels)."""
    coords, colors, labels = make_scene(rng, n_points=n_points,
                                        num_obj=num_obj, extent=extent)
    coords += rng.standard_normal(coords.shape).astype(np.float32) * 0.03
    return coords, colors, labels


def quantized_sample(coords, colors, labels, num_obj: int, voxel_size: float,
                     name: str = "bench") -> SceneSample:
    vox, umap, imap = sparse_quantize(coords, voxel_size)
    return SceneSample(
        vox_coords=vox, raw_coords=coords[umap],
        feats=colors[umap].astype(np.float32) / 255.0,
        labels=labels[umap].astype(np.int32),
        labels_full=labels.astype(np.int32), inverse_map=imap,
        click_idx={}, scene_name=name, num_obj=num_obj)


def get_args_parser():
    p = argparse.ArgumentParser("Per-click forward_mask latency")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, host clock)")
    p.add_argument("--n_points", default=400000, type=int)
    p.add_argument("--reps", default=20, type=int,
                   help="timed forward_mask calls per dtype")
    p.add_argument("--warmup", default=3, type=int)
    p.add_argument("--backbone_reps", default=5, type=int)
    p.add_argument("--out", default=None,
                   help="also write the JSON line to this file")
    return p


@torch.no_grad()
def main(args) -> dict:
    device = resolve_device(args.device)
    cfg = Config()
    rng = np.random.default_rng(0)
    sample = quantized_sample(*noisy_scene(rng, args.n_points, NUM_OBJ, 8.0),
                              NUM_OBJ, cfg.model.voxel_size)
    n_valid = len(sample.vox_coords)
    print(f"bench scene: {n_valid} voxels", file=sys.stderr)
    batch = collate_scenes([sample], cfg.buckets)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=0,
                                                 device="cpu"), device)
    model = engine.model

    calls = [0]

    def backbone():
        calls[0] += 1
        return engine.run_backbone(batch)

    bb_ms = time_ms(backbone, device, reps=args.backbone_reps, warmup=1)
    launches0 = (banded_conv.launches, banded_stem_conv.launches)
    scene = backbone()
    per_backbone = {"banded_conv": banded_conv.launches - launches0[0],
                    "banded_stem": banded_stem_conv.launches - launches0[1]}

    # a mid-session click table: 24 clicks over the 8 objects
    clicks = HostClicks(cfg.model.max_clicks)
    clicks.extend(NewClicks(
        rng.integers(0, n_valid, NUM_CLICKS).astype(np.int32),
        np.tile(np.arange(NUM_OBJ, dtype=np.int32) + 1, 3)[:NUM_CLICKS],
        np.arange(NUM_CLICKS, dtype=np.int32)))
    mc = engine._click_bucket(clicks.count)
    cs = stack_clicks([clicks], mc, device)
    num_obj = torch.tensor([NUM_OBJ], dtype=torch.int32, device=device)

    # the serving dtype casts the scene once per scene, as forward_backbone
    # does under decoder_dtype="bfloat16"
    scenes = {"float32": scene,
              "bfloat16": scene._replace(
                  mask_feat=scene.mask_feat.to(torch.bfloat16),
                  pos_pcd=scene.pos_pcd.to(torch.bfloat16))}
    p50, wall = {}, {}
    for dtype, sc in scenes.items():
        model.cfg = dataclasses.replace(cfg.model, decoder_dtype=dtype)
        run = lambda sc=sc: model.forward_mask(sc, cs, num_obj)
        p50[dtype] = time_ms(run, device, reps=args.reps, warmup=args.warmup)
        wall[dtype] = wall_ms(run, device, reps=args.reps)
    model.cfg = cfg.model
    print(f"forward_mask p50 {p50['float32']:.3f} ms (bf16 "
          f"{p50['bfloat16']:.3f}); backbone {bb_ms:.3f} ms",
          file=sys.stderr)

    n_rows, q = scene.mask_feat.shape[1], cfg.model.num_bg_queries + mc
    bb_costs = backbone_costs(batch.pyramid, cfg.model.backbone)
    bb_roof = summarize(bb_costs, measured_s=bb_ms / 1e3)
    bb_roof["padded_flops"] = summarize(backbone_costs(
        batch.pyramid, cfg.model.backbone, padded=True))["model_flops"]
    fm_roof = summarize(decoder_costs(n_rows, q, cfg.model),
                        measured_s=p50["float32"] / 1e3)
    fm16_roof = summarize(decoder_costs(n_rows, q, cfg.model, dtype_bytes=2),
                          measured_s=p50["bfloat16"] / 1e3)
    result = {
        "metric": "per_click_forward_mask_p50_latency",
        "value": p50["float32"],
        "unit": "ms",
        "vs_baseline": LIMIT_MS / p50["float32"],
        "raw": {
            "device": device_label(device),
            "n_voxels": n_valid,
            "rows": n_rows,
            "queries": q,
            "backbone": {"reps": args.backbone_reps, "ms": bb_ms,
                         "calls": calls[0], "launches": per_backbone},
            "forward_mask": {"reps": args.reps, "p50_ms": p50["float32"],
                             "wall_p50_ms": wall["float32"]},
            "forward_mask_bf16": {"reps": args.reps,
                                  "p50_ms": p50["bfloat16"],
                                  "wall_p50_ms": wall["bfloat16"]},
        },
        "roofline": {
            "backbone": bb_roof,
            "forward_mask": fm_roof,
            "forward_mask_bf16": fm16_roof,
            "backbone_stages": stage_table(bb_costs),
        },
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main(get_args_parser().parse_args())
