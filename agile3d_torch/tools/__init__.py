"""The port's counterparts of the repository's ``tools/``: the TPU probes
that reach a Pallas kernel, each timing its hand-written CUDA kernel
beside the plain version and a library call, and the tools that drive the
package at scale (the training regime and the longer evidence run, a
KITTI-360-size scene, the two eval rollouts side by side, the sharded
backbone's memory a rank, the dp epoch table).

    python -m agile3d_torch.tools.probe_banded_kernel [--points N] [--device cuda|cpu]
    python -m agile3d_torch.tools.probe_smem_gather [--points N] [--device cuda|cpu]
    python -m agile3d_torch.tools.train_regime [WORKDIR] [--epochs 110] ...
    python -m agile3d_torch.tools.train_evidence [WORKDIR] [EPOCHS]
    python -m agile3d_torch.tools.stress_kitti [--points 1200000] ...
    python -m agile3d_torch.tools.compare_rollout_paths [--out DIR] ...
    python -m agile3d_torch.tools.measure_sp_hbm [--points 4000000] [--sp 8]
    python -m agile3d_torch.tools.bench_dp_scaling

They run on the card unless ``--device cpu`` is given; on the CPU the
wrappers compute the plain versions, and the times are the CPU's. This
module holds what the probes and the stress tool share: the probe scene,
timing, the card's name and power limit, the card's least time for a
piece of work, and the spawned ranks' backend.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks: dense bf16 tensor-core rate, FP32 rate on the
# CUDA cores (an FMA counted as two operations) and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 66.9e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time on the card (ms) for ``flops`` operations at ``peak``
    (bf16 tensor-core products unless given) and ``nbytes`` of device
    memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card "
                           "unless --device cpu is given")
    return device


# cycles of the spin kernel that each timed call on the card waits behind
# (about 0.5 ms), so that the host's launch work overlaps it
_PREROLL_CYCLES = 1_000_000


def time_ms(fn, device: torch.device, reps: int = 10,
            warmup: int = 2) -> float:
    """Median time of ``fn`` over ``reps`` calls. On the card: CUDA events
    around each call, enqueued behind a short spin kernel, so that the
    events time the device's work and not the host's launch of it (host
    work beyond the spin's ~0.5 ms still counts); on the CPU: the host
    clock."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_PREROLL_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def wall_ms(fn, device: torch.device, reps: int = 10) -> float:
    """Median host-clock time of ``fn`` through a synchronize: what a
    caller waits, launches included."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def rank_backend(device: torch.device, world: int) -> str:
    """The backend of ``world`` spawned ranks: ``nccl``, one card a rank,
    where the machine has that many cards, else ``gloo`` (ranks sharing
    the one card, or the CPU)."""
    on_cards = device.type == "cuda" and torch.cuda.device_count() >= world
    return "nccl" if on_cards else "gloo"


def device_label(device: torch.device) -> str:
    """What the times were taken on: the card's name and power limit as
    ``nvidia-smi`` reports them, or the CPU."""
    if device.type != "cuda":
        return "cpu (plain versions; not card times)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def probe_scene(points: int):
    """The TPU probes' scene through the port's host prep: the synthetic
    room of ``points`` points with 8 objects over 8 m, 0.03 m of noise,
    quantized at the model's voxel size, its pyramid padded to buckets."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.synthetic import make_scene
    from agile3d_torch.sparse.grid import pad_pyramid
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    cfg = Config()
    rng = np.random.default_rng(0)
    coords, _, _ = make_scene(rng, n_points=points, num_obj=8, extent=8.0)
    coords += rng.standard_normal(coords.shape).astype(np.float32) * 0.03
    vox, _, _ = sparse_quantize(coords, cfg.model.voxel_size)
    return pad_pyramid(build_pyramid(vox), buckets=cfg.buckets)
