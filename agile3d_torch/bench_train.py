"""Training throughput benchmark: ``python -m agile3d_torch.bench_train``.

The port's counterpart of the JAX package's root ``bench_train.py``: scenes
per second of the supervised step (backbone and decoder forward with
gradients, losses, backward, clipped AdamW) at the canonical batch of 5
synthetic scenes of 150,000 points, with a fixed click table (no click
rollout). Then an epoch's stepping over ``--batches`` fresh batches,
serially and with the batches assembled ahead on a host thread
(``data/prefetch.py``, depth 2), to show how much host time the prefetcher
hides: host prep on the native runtime (``sparse/native.py``, the
default), then again on the numpy path (``AGILE3D_NATIVE=0``) under
``breakdown.numpy_host``. The last line printed is one JSON object with
``bench_train.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``breakdown``, ``roofline``; the share of the bf16
tensor-core peak is ``mfu``).

Times: the step by CUDA events (``tools.time_ms``, median of ``--reps``
after one warm-up step); host assembly and the epoch stepping by the host
clock through a synchronize. ``--device cpu`` runs the plain versions on
the CPU, with times that are not the card's.

    python -m agile3d_torch.bench_train [--device cpu] [--batch_size 5]
        [--n_points 150000] [--batches 4] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from agile3d_torch.bench import noisy_scene, quantized_sample
from agile3d_torch.config import Config, TrainConfig
from agile3d_torch.data.datasets import collate_scenes
from agile3d_torch.data.prefetch import BatchPrefetcher
from agile3d_torch.engine.eval import InteractiveEngine, resolve_device
from agile3d_torch.engine.train import make_optimizer, make_train_step
from agile3d_torch.models.agile3d import ClickState, init_agile3d
from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
from agile3d_torch.sparse import native
from agile3d_torch.tools import device_label, time_ms
from agile3d_torch.utils.costs import (
    PEAK_BF16_FLOPS,
    backbone_costs,
    decoder_costs,
    summarize,
)

NUM_OBJ = 6
MAX_CLICKS = 64
NUM_CLICKS = 12


def get_args_parser():
    p = argparse.ArgumentParser("Training step throughput")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, host clock)")
    p.add_argument("--batch_size", default=5, type=int)
    p.add_argument("--n_points", default=150000, type=int)
    p.add_argument("--reps", default=3, type=int,
                   help="timed supervised steps")
    p.add_argument("--batches", default=4, type=int,
                   help="batches of each epoch-stepping run")
    p.add_argument("--out", default=None,
                   help="also write the JSON line to this file")
    return p


def fixed_clicks(rng, batch, batch_size: int, device) -> ClickState:
    """12 clicks per sample, every object clicked at least once (as the
    rollout guarantees), the last one on the background."""
    vox = np.full((batch_size, MAX_CLICKS), -1, np.int32)
    obj = np.zeros((batch_size, MAX_CLICKS), np.int32)
    tim = np.zeros((batch_size, MAX_CLICKS), np.int32)
    for i in range(batch_size):
        nv = int((batch.sample_idx[i] >= 0).sum())
        vox[i, :NUM_CLICKS] = rng.integers(0, nv, NUM_CLICKS)
        obj[i, :NUM_CLICKS] = (np.arange(NUM_CLICKS) % NUM_OBJ) + 1
        obj[i, NUM_CLICKS - 1] = 0
        tim[i, :NUM_CLICKS] = np.arange(NUM_CLICKS)
    return ClickState(*(torch.from_numpy(a).to(device)
                        for a in (vox, obj, tim)))


def main(args) -> dict:
    device = resolve_device(args.device)
    bs = args.batch_size
    cfg = Config(train=TrainConfig(batch_size=bs))
    vs = cfg.model.voxel_size
    rng = np.random.default_rng(0)
    samples = [quantized_sample(*noisy_scene(rng, args.n_points, NUM_OBJ,
                                             6.0), NUM_OBJ, vs, f"s{i}")
               for i in range(bs)]
    batch = collate_scenes(samples, cfg.buckets)
    total_vox = int(sum(len(s.vox_coords) for s in samples))
    n_rows = int(batch.pyramid.levels[0].grid.shape[0])
    print(f"train batch: {bs} scenes, {total_vox} voxels (level-0 bucket "
          f"{n_rows})", file=sys.stderr)

    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=0,
                                                 device="cpu"), device)
    optimizer, _ = make_optimizer(engine.model, cfg, steps_per_epoch=100)
    train_step = make_train_step(cfg, engine.model, optimizer)
    clicks = fixed_clicks(rng, batch, bs, device)

    steps = [0]

    def step(b):
        steps[0] += 1
        return train_step(engine.device_batch(b), clicks,
                          torch.from_numpy(b.labels).to(device),
                          torch.from_numpy(b.num_obj).to(device))

    launches0 = (banded_conv.launches, banded_conv_dw.launches)
    float(step(batch)["loss"])  # the warm-up step, launches counted
    per_step = {"banded_conv": banded_conv.launches - launches0[0],
                "banded_conv_dw": banded_conv_dw.launches - launches0[1]}
    step_ms = time_ms(lambda: step(batch), device, reps=args.reps, warmup=0)
    step_s = step_ms / 1e3

    # epoch stepping over fresh batches: serial, then prefetched
    raw_scenes = [noisy_scene(rng, args.n_points, NUM_OBJ, 6.0)
                  for _ in range(args.batches * bs)]

    def prepare(bi):  # quantize, pyramid and collate: the host's share
        return collate_scenes(
            [quantized_sample(*sc, NUM_OBJ, vs, "s")
             for sc in raw_scenes[bi * bs:(bi + 1) * bs]], cfg.buckets)

    def assembly_ms():
        t0 = time.perf_counter()
        prepare(0)
        return (time.perf_counter() - t0) * 1e3

    def run_epoch(depth, n):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for b in BatchPrefetcher(prepare, range(n), depth=depth):
            float(step(b)["loss"])
        return (time.perf_counter() - t0) / n * 1e3

    def host_times():
        return {"host_batch_assembly_ms": assembly_ms(),
                # host and device alternate, then host assembly on a thread
                "epoch_step_serial_ms": run_epoch(0, args.batches),
                "epoch_step_prefetch_ms": run_epoch(2, args.batches)}

    run_epoch(0, 1)                          # one batch to warm the loop
    host_path = "native" if native.enabled() else "numpy"
    host = host_times()
    numpy_host = None
    if host_path == "native":
        with native.disabled():
            numpy_host = host_times()
    print(f"supervised step {step_ms:.1f} ms; epoch stepping serial "
          f"{host['epoch_step_serial_ms']:.0f} ms/step, prefetch "
          f"{host['epoch_step_prefetch_ms']:.0f} ms/step (host assembly "
          f"{host['host_batch_assembly_ms']:.0f} ms, {host_path})",
          file=sys.stderr)

    # step FLOPs: the forward's useful work (costs.py) x 3, the backward
    # costing about twice the forward
    q = cfg.model.num_bg_queries + MAX_CLICKS
    fwd = (summarize(backbone_costs(batch.pyramid, cfg.model.backbone))
           ["model_flops"]
           + summarize(decoder_costs(n_rows, q, cfg.model))["model_flops"])
    step_flops = 3 * fwd
    result = {
        "metric": "train_scenes_per_sec_per_chip",
        "value": bs / step_s,
        "unit": "scenes/s",
        "vs_baseline": None,
        "breakdown": {
            "supervised_step_ms": step_ms,
            **host,
            "host_path": host_path,
            "numpy_host": numpy_host,
            "batch_scenes": bs,
            "batch_voxels": total_vox,
            "padded_rows": n_rows,
            "steps": steps[0],
            "launches_per_step": per_step,
            "device": device_label(device),
        },
        "roofline": {
            "step_flops_3x_fwd": int(step_flops),
            "achieved_tflops": step_flops / step_s / 1e12,
            "mfu": step_flops / step_s / PEAK_BF16_FLOPS,
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
