#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agile3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  -- the card, its power limit, and the build of the CUDA kernels
                from ``agile3d_torch/csrc`` (one nvcc per source, all at once);
  2. kernels -- each kernel at the main paths' shapes (the eval smoke
                scene's neighbour maps; the training batch's for the
                training forward, dX and dW), then B1 at the Res16UNet
                variants' shapes (416 -> 384, 384 -> 384, 256 -> 256,
                96 -> 64 on the smoke scene's two finest maps; dX and dW at
                416 -> 384 and 256 -> 256 on the training reference batch's
                65,536-row level), against its plain PyTorch
                version on the card, with device times from CUDA events
                (median of 5 after warm-up, each call behind a short spin
                kernel so that the host's launch work is not timed) for the
                kernel, the plain version and a library yardstick (one bf16
                gather and one cuBLAS matmul, timed here only), beside the
                card's least time for the same work; then the boundary
                distance of the device rollout, bit for bit against its
                plain version, at an eval round's and a training round's
                shapes (the error rows queried, as the main paths call
                it, then every row), a ragged N, all rows invalid and one
                cluster, with the pairs it evaluated against the all-pairs
                count (and a parent commit's kernel, see below); then
                round 0 of the device eval on the smoke scene (``round0``):
                its distance call (every object row queried) bit for bit
                against the host loops' plain torch distance, both timed,
                and its clicks equal to ``simulate_clicks``'s;
  3. probes -- the kernels of the TPU probes' counterparts: the windowed
                banded k3 conv (its plan covers every neighbour of the
                smoke scene's two finest maps) at the eval k3 shapes against
                its plain version and ``banded_conv_reference``, timed
                beside ``banded_conv``; the cluster row gather from the 384-
                row table and the TPU probe's own 4,096-row table, exact
                against ``x[idx]``, timed; then both probe entry points
                (``agile3d_torch.tools``, in process), with the two kernels'
                launches counted around them;
  4. decoder -- ``forward_mask`` on the smoke scene at full width, dense
                and chunked (JAX's rule picks 32,768: 6 chunks), in f32 and
                bf16: CUDA-event and host-clock times, peak memory; chunked
                against dense at f32, bf16 against f32 by labels; then one
                chunked forward per dtype at a KITTI-360-size shape (786,432
                rows, 256 clicks) and its peak memory;
  5. reference -- the full-width model on a mid-size scene on the card
                (kernels on, then off) against the same model on the CPU,
                the plain float32 path that the CPU tests hold against the
                JAX package; and the bf16 decoder on the card against the
                CPU's on the same scene features;
  6. train reference -- one supervised step at full width on two such
                scenes: the CPU (plain f32), the card with the kernels off
                and the card with them on; losses, every gradient, gnorm
                and the committed BatchNorm statistics compared, launches
                counted;
  7. main path -- ``python -m agile3d_torch.eval_multi_obj`` (in process) on
                the synthetic smoke scene (400,000 points, 8 objects) at full
                Res16UNet34C width with seeded random weights, the reference
                model block passed at its defaults, 5 clicks per
                object (the click table crosses a bucket): the default
                device rollout, then ``--host_rollout``, each with the
                kernels' launch counts read around it (one boundary-distance
                launch for round 0 and one per device round; the probes'
                kernels: 0); the CSV
                rows of the two must agree, and the decoder must see the
                same click bucket in each round of both; then once more with
                the memory budget pinned at 0.01 GiB (``AGILE3D_HBM_GIB``):
                one ``error:`` line, a non-zero exit and no kernel launch;
  8. single -- ``python -m agile3d_torch.eval_single_obj`` (in process) on
                the smoke scene's first 2 objects at the default 20 clicks:
                the device rollout, then ``--host_rollout``; rows equal, 8 k3
                and 1 stem launches per object, one distance launch per
                object's round 0 and per device round, the evaluator
                finite, then
                ``python -m agile3d_torch.compute_ap`` on the CSV;
  9. serve -- the annotation server (``agile3d_torch.interactive``) on the
                smoke scene at bf16 (the serving default) and f32: the scene
                load (8 k3, 1 stem), a scripted 20-click session (per-click
                wall and decoder times, p50 / p90 beside the 50 ms limit,
                which is reported and not enforced; no kernel launch per
                click) and one ``POST /click`` through the HTTP front end
                on localhost;
  11. variants -- Res16UNet14D (BasicBlock) through the whole model on the
                smoke scene, kernels on then off, and ``evaluate_dataset``
                through the device rollout at 2 clicks per object;
                Res16UNet101 (Bottleneck) as the backbone alone, kernels on
                and off, and ``Agile3D`` refusing it; B1 launches as the
                routing rule predicts (4 and 4), one stem launch;
  12. memory -- the peak device memory of one eval ``forward_backbone``
                and ``forward_mask`` at the smoke scene's 196,608 rows and at
                a scene that pads to 786,432 (KITTI-360 size), against the
                oversize guard's estimate;
  10. train main path -- ``python -m agile3d_torch.main`` (in process): 5
                of 10 synthetic scenes of ~94,000 voxels, batch 5 (the
                524,288-row level-0 bucket), one epoch of 1 step and one
                validation at
                full width, launches counted per step (24 k3, 8 dW, 0
                stem; the probes' kernels 0), the rollout, the supervised
                step and the backbone's forward and backward timed with
                CUDA events; then one step with ``--device_rollout`` at a
                fixed round count, whose batch then goes through the device
                and the host rollouts with the click order pinned: the
                click sets must agree;
  13. benches -- ``python -m agile3d_torch.bench`` and ``bench_train``
                (``--batches 1 --reps 2 --n_points 75000``) in process: their
                JSON lines finite, 8 k3
                + 1 stem launches per eval backbone forward, 16 k3 + 8 dW
                per supervised step.

The tenth slice (resumable training, decoder dropout, the bf16 backbone)
adds: in the kernels phase, the main paths' B1, B2 and B3 shapes again
with bf16 operands (roles ``bf16 *``), each launch equal bit for bit to
the f32 launch on the same values and timed beside it; after the training
reference (whose supervised step it reuses),
  bf16 backbone -- ``backbone_dtype="bfloat16"``: the eval
                ``forward_backbone`` on the smoke scene, kernels on and off
                (8 k3 + 1 stem launches, f32 FPN maps), one
                ``forward_mask``'s labels against the f32 backbone's, the
                backbone's ms against f32's, and one supervised step on the
                training reference batch against the CPU's f32 step;
  dropout -- one supervised step at ``--dropout 0.1`` on that batch: dense
                attention where the rate-0 step chunks, a loss of its own,
                two steps from one seed equal, time and peak memory;
in the training main path, one step of its 524,288-row batch with the
bf16 backbone (24 k3 + 8 dW launches, against the f32 step from the same
weights) and one at ``--dropout 0.1`` (dense, its peak memory), and the
validation's loss meter; and after the device-rollout step,
  resume -- ``python -m agile3d_torch.main`` (in process) for one epoch on
                the training reference scenes, then ``--resume`` its
                ``checkpoint.pth`` with ``--epochs 2``: it starts at epoch 1,
                the weights, BatchNorm statistics and optimizer state
                restored bit for bit, launches per step as the routing rule
                gives them.

The eleventh slice (the boundary-distance kernel redesigned; the native
host runtime) adds: the distance cases with the query mask; with
``AGILE3D_PARENT=DIR`` (a parent commit unpacked with ``git archive``) the
parent's distance kernel built from ``DIR`` and timed beside this one in
turns on the same inputs, bit for bit too; around every main path that
prepares scenes (eval, single, serve, training, the device-rollout step,
resume, benches) the count of pyramids and quantized clouds by host path,
failing if one took the numpy path (the benches, whose ``bench_train``
also times the numpy path on purpose, must take the native one too); and
``bench_train``'s host assembly and epoch stepping on both host paths.

The twelfth slice (the parallel paths on ``torch.distributed``) adds,
after the resume phase,
  parallel -- two ``gloo`` ranks sharing the one card (function and
                memory, not scaling): the voxel-sharded decoder on the
                smoke scene against the one-process ``forward_mask``
                (JAX's 2e-3 band; labels equal where the top two logits
                part by more), each timed; ``eval_multi_obj --sp 2`` and
                ``--sp 2 --sp_backbone`` (``main(args)`` inside the ranks'
                group) at 2 clicks an object against the one-process device
                rollout (IoUs within 1e-4; on each rank one distance launch
                for round 0 and one per round; 8 k3 + 1 stem from the
                one-process backbone, none
                from the sharded one; each halo exchange's rows and bytes);
                one dp step on two identical groups against the one-process
                step, then ``main --num_dp 2`` for one epoch of 4 training
                reference scenes (65,536 rows a replica), each rank's
                launches equal to the one-process ``--device_rollout``
                rollout and step on its batch; in this process,
                ``--scene_parallel 2`` (one device on one card) against the
                serial host loop, rows equal, ``--sp 2`` with no group
                refused on nccl in one ``error:`` line, and what NCCL itself
                says to two ranks on one card (reported; the probe must
                reach NCCL).
The kernels line's ``launches_by_path`` gains ``sp_eval``,
``sp_backbone_eval`` and ``dp_train`` (summed over the two ranks).

The thirteenth slice (the repository's tools on the port) adds, after the
parallel phase,
  regime -- ``python -m agile3d_torch.tools.train_regime`` (in process;
                ``main`` runs as its child) at a miniature: 5 train and 2
                val scenes of 30,000 points, 4 epochs of 1 step, the drop
                at 3, validation every 2; a first piece cut (TERM, as
                ``--max_seconds`` cuts) once epoch 1 and its validation
                are done, then ``--resume``: both val curves, one from
                each piece, none lost, the LR 1e-5 from the drop
                on, every step taken, and the launches that the children
                log (12 B1 and 4 B3 a step for each banded level, none in
                the validations, 1-20 distance launches a step);
  stress -- ``python -m agile3d_torch.tools.stress_kitti`` (in process) at
                1.2M points over 22 m (786,432 rows): the chunked attention
                engaged as the rule picks it, finite masks, the footprint
                of one backbone and one decoder pass under the oversize
                guard's estimate, 4 B1 a banded level and 1 B2 a pass;
  rollout paths -- ``python -m agile3d_torch.tools.compare_rollout_paths``
                (in process) on 2 scenes of 50,000 points at 3 clicks an
                object: no trajectory diverges, the two ``EvaluatorMO``
                dicts equal, one distance launch a trajectory's round 0
                and a device round, and none in the host loop.
``launches_by_path`` gains ``regime``, ``stress`` and ``rollout_paths``.

The fourteenth slice (the last two tools) adds, after the rollout paths,
  sp_hbm -- ``python -m agile3d_torch.tools.measure_sp_hbm`` (in process)
                at the stress scene (786,432 rows) on 2 ranks sharing the
                card: the one-process eval backbone's peak (8 B1, 1 B2)
                above each rank's, the sharded backbone launching no
                kernel, and the ranks' scene features, gathered back,
                equal to the one-process pass of the plain convs within
                the sharded backbone's bounds (mask_feat 2e-4, pos_pcd
                1e-5, cmin / cmax 1e-6) and to the pass with the kernels
                within the reference phase's 5e-2 x (max + 1);
  dp scaling -- ``python -m agile3d_torch.tools.bench_dp_scaling`` (in
                process) at widths 1 and 2, 2 steps an epoch: finite
                epochs, one distance launch a round on each rank and no
                other launch (function, not scaling: the ranks share the
                card).
``launches_by_path`` gains ``sp_hbm`` and ``dp_scaling``. To hold the run's
time, earlier paths run at a smaller depth (the old depth in brackets):
medians of 5 timed calls for the kernels, the probes and the decoder (10);
``main`` trains 1 step (2) and the backbone's backward is timed over 2
passes (4); the single phase takes 2 objects (3); the SP rollouts 2
clicks an object (3); the regime 5 train and 2 val scenes, 4 epochs of 1
step (10 and 4, 2 steps); ``bench`` 10 timed decoder calls a dtype (20);
``bench_train`` 2 timed steps, 1 batch of epoch stepping and scenes of
75,000 points (3, 2, 150,000). A ``phase_seconds`` line before
``total_s`` gives each phase's wall time.

Then the kernels line, the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import io
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SMOKE_SCENE = dict(num_scenes=1, num_obj=8, n_points=400000, extent=8.0, seed=0)
REF_SCENE = dict(num_scenes=1, num_obj=4, n_points=60000, extent=4.0, seed=1)
# 5 clicks per object: 33 rounds after round 0, whose decoder sees 8-40
# clicks, so the click table crosses the 32 -> 64 bucket
MAX_NUM_CLICKS = 5
# training: 10 scenes of ~94,000 voxels (ScanNet-sized), 5 per batch, so
# every batch pads to the 524,288-row level-0 bucket; main trains on the
# first TRAIN_STEPS batches (1 step in one epoch; it ran 2)
TRAIN_SCENES = dict(num_scenes=10, num_obj=8, n_points=190000, extent=6.0,
                    seed=2)
TRAIN_BATCH = 5
TRAIN_STEPS = 1
# the backbone's backward timed in training: passes, the first a warm-up
# (it ran 4)
BACKWARD_PASSES = 2
# the training reference: two scenes of ~25,000 voxels in one batch (a
# 65,536-row level 0, so its four k3 convs take the kernels), small enough
# for two full-width steps on the CPU
TRAIN_REF_SCENES = dict(num_scenes=2, num_obj=4, n_points=36000, extent=4.0,
                        seed=1)
# the training step with --device_rollout: its rounds (0..DEVICE_ITERS)
DEVICE_ITERS = 5
# the single-object phase: the smoke scene's first objects, each one
# instance of the InterObject3D protocol at its default 20-click budget
# (2 objects; it ran 3)
SINGLE_OBJECTS = 2
# the serving phase: a scripted annotation session of this many clicks on
# the smoke scene, and PERF.md's per-click limit (reported, not enforced)
SERVE_CLICKS = 20
SERVE_LIMIT_MS = 50.0
# a KITTI-360-size scene for the chunked decoder's memory: the 786,432-row
# bucket (~670,000 voxels) and a 256-click table
KITTI_ROWS = 786432
KITTI_VALID = 670000
KITTI_CLICKS = 256
DEVICE = "cuda"
# the Res16UNet variants' new shapes for B1 at the smoke scene's two finest
# levels (14D: 416 -> 384, 384 -> 384; 50 / 101: the Bottleneck's middle
# 256 -> 256; 34A: 96 -> 64), and for dX and B3 at the training reference
# batch's 65,536-row level 0
VARIANT_FORWARD = ((416, 384), (384, 384), (256, 256), (96, 64))
VARIANT_BACKWARD = ((416, 384), (256, 256))
# the variants phase: the whole model (a BasicBlock variant) and the
# backbone alone (a Bottleneck variant, which the model refuses, as JAX's)
VARIANT_MODEL = "Res16UNet14D"
VARIANT_BACKBONE = "Res16UNet101"
VARIANT_CLICKS = 2
# the reference model block at its default values, as a launch script
# passes it (agile3d_torch/cli.py)
REFERENCE_BLOCK = [
    "--voxel_size", "0.05", "--hidden_dim", "128", "--dim_feedforward",
    "1024", "--num_heads", "8", "--num_decoders", "3", "--num_bg_queries",
    "10", "--dropout", "0.0", "--pre_norm", "", "--normalize_pos_enc", "t",
    "--positional_encoding_type", "fourier", "--gauss_scale", "1.0",
    "--hlevels", "4", "--shared_decoder", "", "--aux", "t", "--bn_momentum",
    "0.02", "--conv1_kernel_size", "5", "--dialations", "1", "1", "1", "1",
    "--decoder_dtype", "float32", "--max_clicks_budget", "256"]
# a scene that pads to the 786,432-row bucket (~602,000 voxels, the
# KITTI-360 size) for the eval footprint
MEMORY_SCENE = dict(num_scenes=1, num_obj=8, n_points=1400000, extent=14.0,
                    seed=3)
# the benches' arguments: bench's 10 timed decoder calls a dtype (its
# default is 20); bench_train's 2 timed steps (3), epoch stepping over 1
# batch (4), scenes of 75,000 points (150,000; both finest levels stay
# banded)
BENCH_ARGS = ["--reps", "10"]
BENCH_TRAIN_ARGS = ["--batches", "1", "--reps", "2", "--n_points", "75000"]


def emit(obj) -> None:
    print(json.dumps(obj, allow_nan=False), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# timed calls of every kernel, plain version, library call and decoder
# form (medians; it ran 10)
TIMING_REPS = 5


def finite(x):
    return None if x is None or not math.isfinite(x) else x


def time_ms(torch, fn, reps: int = TIMING_REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls on the card: CUDA
    events, each call enqueued behind a short spin kernel so that the
    wrapper's host time is not counted (``agile3d_torch.tools.time_ms``)."""
    from agile3d_torch.tools import time_ms as timed

    return timed(fn, torch.device(DEVICE), reps=reps, warmup=warmup)


def wall_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    """Median host-clock time of ``fn`` through a synchronize: what a
    caller waits, launches included (``agile3d_torch.tools.wall_ms``)."""
    from agile3d_torch.tools import wall_ms as walled

    return walled(fn, torch.device(DEVICE), reps=reps)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def zero_launches() -> None:
    from agile3d_torch.utils.profiling import kernel_wrappers

    for w in kernel_wrappers().values():
        w.launches = 0


@contextlib.contextmanager
def chunks_seen():
    """The attention chunk of every ``forward_mask`` call inside the block
    (0 = dense), counted by value."""
    from agile3d_torch.models.agile3d import Agile3D

    seen = {}
    orig = Agile3D.forward_mask

    def forward_mask(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        seen[out["attn_chunk"]] = seen.get(out["attn_chunk"], 0) + 1
        return out

    Agile3D.forward_mask = forward_mask
    try:
        yield seen
    finally:
        Agile3D.forward_mask = orig


@contextlib.contextmanager
def timed_calls(torch, owner, name: str, store: list):
    """``owner.name`` wrapped in CUDA events for the block: each call
    appends its (start, end) pair to ``store``."""
    orig = getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        store.append((start, end))
        return out

    setattr(owner, name, wrapper)
    try:
        yield store
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


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


def bound(nbr, cin: int, cout: int, x_bytes: int = 4, w_bytes: int = 4,
          y_bytes: int = 4) -> tuple[float, str]:
    """Least time for y = sum_j bf16(x[nbr[:, j]]) @ bf16(w[j]) on the card:
    each input read once (x, w and y at the given element sizes, the map
    int32) and the output written once, against the products this map's
    present neighbours need at the bf16 tensor-core peak."""
    n, k = nbr.shape
    nnz = int((nbr >= 0).sum())
    flops = 2.0 * nnz * cin * cout
    nbytes = (x_bytes * n * cin + 4.0 * n * k + w_bytes * k * cin * cout
              + y_bytes * n * cout)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def tpu_kernel(module: str, func: str) -> str:
    """``file:line`` of what a CUDA kernel replaces: the definition of
    ``func`` in ``ops/<module>`` (a Pallas kernel) or ``engine/<module>``
    (an XLA fusion) of the JAX package beside the port, or in
    ``tools/<module>`` for the TPU probes (read as text; nothing of either
    is imported)."""
    port = os.path.join(ROOT, "agile3d_torch")
    paths = sorted(glob.glob(os.path.join(ROOT, "*", "ops", module))
                   + glob.glob(os.path.join(ROOT, "*", "engine", module)))
    paths.append(os.path.join(ROOT, "tools", module))
    for path in paths:
        if path.startswith(port + os.sep) or not os.path.exists(path):
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if line.startswith(f"def {func}("):
                    return f"{os.path.relpath(path, ROOT)}:{i}"
    fail(f"no definition of {func} in ops/ or engine/{module} of the JAX "
         f"package or in tools/{module}")


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


def kernel_cases(eval_pyr, train_pyr, ref_pyr):
    """(kernel, role, level, cin, cout, count) at the main paths' shapes,
    then at the variants' new shapes (``ref_pyr``: the training reference
    batch's pyramid, whose level 0 has 65,536 rows).
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
    cases += [("banded_conv", "variant forward", lv, cin, cout, 1)
              for lv in eval_pyr.levels[:2] for cin, cout in VARIANT_FORWARD]
    lv = ref_pyr.levels[0]
    for cin, cout in VARIANT_BACKWARD:
        cases += [("banded_conv", "variant dX", lv, cout, cin, 1),
                  ("banded_conv_dw", "variant dW", lv, cin, cout, 1)]
    # the main paths' shapes again with bf16 operands (the bf16 backbone):
    # B1 and B2 at the eval forward's, B1 forward and dX and B3 at the
    # training step's
    cases += [(name, f"bf16 {role}", lv, cin, cout, count)
              for name, role, lv, cin, cout, count in list(cases)
              if role in ("eval", "train forward", "dX", "dW")]
    return cases


def phase_kernels(torch, cases):
    """Kernel vs plain version on the card at the main paths' shapes. A
    ``bf16 *`` role takes bf16 x and w (or g): its launch must equal the
    f32 launch on the same values bit for bit (a bf16 operand casts to
    itself), and that launch's time is kept beside it."""
    from agile3d_torch.ops.banded_conv import (
        banded_conv,
        banded_conv_dw,
        banded_conv_dw_reference,
        banded_conv_reference,
    )
    from agile3d_torch.ops.banded_stem import (
        banded_stem_conv,
        banded_stem_conv_reference,
        stem_prep,
    )

    fns = {"banded_conv": (banded_conv, banded_conv_reference),
           "banded_stem": (banded_stem_conv, banded_stem_conv_reference),
           "banded_conv_dw": (banded_conv_dw, banded_conv_dw_reference)}
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for name, role, lv, cin, cout, count in cases:
        kern, plain = fns[name]
        bf16 = role.startswith("bf16")
        nbr = lv.k5 if name == "banded_stem" else lv.k3
        n, k = nbr.shape
        x = torch.randn((n, cin), generator=g, device=DEVICE)
        x[lv.num_valid:] = 0.0
        opts = {}
        if name == "banded_conv_dw":
            # the cotangent of the conv's output: zero on pad rows
            other = torch.randn((n, cout), generator=g, device=DEVICE)
            other[lv.num_valid:] = 0.0
        elif role.endswith("dX"):
            # as BandedConv's backward calls it: the forward's [k, cout,
            # cin] weights, read as flip(w, 0).transpose(1, 2)
            other = torch.randn((k, cout, cin), generator=g, device=DEVICE) \
                * (k * cin) ** -0.5
            opts = {"transposed": True}
        else:
            other = torch.randn((k, cin, cout), generator=g, device=DEVICE) \
                * (k * cin) ** -0.5
        if bf16:
            x32, other32 = x.to(torch.bfloat16).float(), other.to(
                torch.bfloat16).float()
            x, other = x.to(torch.bfloat16), other.to(torch.bfloat16)
        run = lambda: kern(x, nbr, other, **opts)
        plain_other = other.flip(0).transpose(1, 2) if opts else other
        y = run()
        ref = plain(x, nbr, plain_other)
        torch.cuda.synchronize()
        err = float((y.float() - ref).abs().max())
        ref_max = float(ref.abs().max())
        # and one bf16 rounding of a bf16 output
        tol = 1e-3 * (ref_max + 1.0) + (2.0 ** -8 * ref_max
                                        if y.dtype == torch.bfloat16 else 0.0)
        tag = f"{name} ({role}) {n}x{cin}->{cout}"
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
        check(err <= tol, f"{tag}: max|kernel - plain| {err} > {tol}")
        if bf16:
            run32 = lambda: kern(x32, nbr, other32, **opts)
            y32 = run32()
            check(y.dtype == (torch.float32 if name == "banded_conv_dw"
                              else torch.bfloat16), f"{tag}: dtype {y.dtype}")
            check(torch.equal(y, y32.to(y.dtype)),
                  f"{tag}: the bf16 launch differs from the f32 launch on "
                  f"the same values")
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
        # bf16: x, w (or g) and a conv's output in 2 bytes, dW's in 4
        sizes = ({} if not bf16 else dict(x_bytes=2, w_bytes=4, y_bytes=2)
                 if name == "banded_conv_dw"
                 else dict(x_bytes=2, w_bytes=2, y_bytes=2))
        b_ms, b_by = bound(nbr, cin, cout, **sizes)
        row = dict(kernel=name, role=role, rows=n, cin=cin, cout=cout,
                   count=count, num_valid=lv.num_valid, max_abs_err=err,
                   ref_max=ref_max, tol=tol,
                   rel_err=err / max(ref_max, 1e-30),
                   ms=time_ms(torch, run),
                   plain_ms=time_ms(torch, lambda: plain(x, nbr, plain_other)),
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        if name == "banded_stem":
            # the cast of x and w that each call runs first (in ms)
            row["prep_ms"] = time_ms(torch, lambda: stem_prep(x, other))
        if bf16:
            row.update(dtype="bfloat16", bit_equal_f32=True,
                       f32_ms=time_ms(torch, run32))
            del x32, other32, y32
        emit({"phase": "kernel_parity", **row})
        rows.append(row)
        del x, other, plain_other, y, ref, xz, idx, ob
        torch.cuda.empty_cache()
    return rows


def rollout_inputs(batch):
    """(coords [B, Ns, 3], cluster [B, Ns], valid [B, Ns]) of a collated
    batch as a rollout round after the zero prediction sees them: each
    sample's raw coordinates in its rows, every labelled object an error
    cluster (compact id 11 x label), the background correct (-1)."""
    b, ns = batch.labels.shape
    coords = np.zeros((b, ns, 3), np.float32)
    off = 0
    for i in range(b):
        nv = int((batch.sample_idx[i] >= 0).sum())
        coords[i, :nv] = batch.raw[off:off + nv]
        off += nv
    labels = batch.labels
    cluster = np.where(labels > 0, labels * 11, -1).astype(np.int32)
    return coords, cluster, labels >= 0


def distance_cases(eval_batch, train_batch):
    """(role, count, coords, cluster, valid, query) for the boundary-distance
    kernel: an eval round and a training round as the main paths call it,
    the error rows as the query (count: per round), the same two for every
    row (query None), then a ragged N (random points in random order:
    nothing to cull), all rows invalid and a single cluster (count 0)."""
    rng = np.random.default_rng(0)
    n = 70001
    ragged = ((rng.random((1, n, 3)) * 8).astype(np.float32),
              rng.integers(-1, 12, (1, n)).astype(np.int32),
              rng.random((1, n)) < 0.9, None)
    n = 4096
    invalid = ((rng.random((1, n, 3)) * 8).astype(np.float32),
               rng.integers(-1, 12, (1, n)).astype(np.int32),
               np.zeros((1, n), bool), None)
    n = 50000
    single = ((rng.random((1, n, 3)) * 8).astype(np.float32),
              np.zeros((1, n), np.int32), np.ones((1, n), bool), None)
    ev, tr = rollout_inputs(eval_batch), rollout_inputs(train_batch)
    return [("eval round", 1, *ev, ev[1] >= 0),
            ("train round", 1, *tr, tr[1] >= 0),
            ("eval round, all rows", 0, *ev, None),
            ("train round, all rows", 0, *tr, None),
            ("ragged", 0, *ragged), ("all invalid", 0, *invalid),
            ("one cluster", 0, *single)]


def parent_distance_kernel(torch):
    """The boundary-distance kernel of the checkout at ``$AGILE3D_PARENT``
    (a parent commit unpacked with ``git archive``), built with nvcc:
    (run(coords, cluster, valid, query=None) -> d, takes_query); None when
    the variable is unset. A kernel from before the query mask (PR 7-10)
    has its own entry: scratch for the keys and counts, no query."""
    import ctypes

    from agile3d_torch.ops import boundary_dist, cuda_build

    root = os.environ.get("AGILE3D_PARENT")
    if not root:
        return None
    src = os.path.join(root, "agile3d_torch", "csrc", "boundary_dist.cu")
    check(os.path.exists(src), f"AGILE3D_PARENT: no {src}")
    lib_path = os.path.join(tempfile.mkdtemp(prefix="agile3d_parent_"),
                            "libboundary_dist.so")
    out = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", lib_path, src], capture_output=True,
                         text=True)
    check(out.returncode == 0, f"the parent's kernel did not build:\n"
                               f"{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    if hasattr(lib, "agile3d_boundary_dist_scratch"):
        boundary_dist.bind(lib)
        return (lambda coords, cluster, valid, query=None:
                boundary_dist.launch(lib, coords, cluster, valid, query)), True
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.agile3d_boundary_dist
    fn.restype, fn.argtypes = I, [P, P, P, P, P, P, I, I, P]

    def run(coords, cluster, valid, query=None):
        check(query is None, "the parent's distance kernel takes no query")
        b, n = cluster.shape
        d = torch.empty((b, n), dtype=torch.float32, device=coords.device)
        keys = torch.empty((b, n, 4), dtype=torch.float32,
                           device=coords.device)
        count = torch.zeros(b, dtype=torch.int32, device=coords.device)
        rc = fn(coords.data_ptr(), cluster.data_ptr(), valid.data_ptr(),
                keys.data_ptr(), count.data_ptr(), d.data_ptr(), b, n,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the parent's distance kernel failed to launch: "
                       f"CUDA error {rc}")
        return d

    return run, False


def phase_distances(torch, cases):
    """The boundary-distance kernel bit for bit against its plain version
    on the card, with the (query, key) pairs it evaluated against the
    all-pairs count, and (``$AGILE3D_PARENT``) the parent commit's kernel
    on the same inputs, also bit for bit, timed in the same call. No
    single PyTorch call computes the masked minimum, so it has no library
    time. The bound counts what these inputs need at the least: the bytes,
    and one pair per query row."""
    from agile3d_torch.ops.boundary_dist import (
        all_pairs,
        boundary_distances_all,
        boundary_distances_all_reference,
        distance_work,
    )
    from agile3d_torch.tools import PEAK_FP32_FLOPS, bound_ms

    parent = parent_distance_kernel(torch)
    rows = []
    for role, count, *arrays in cases:
        coords, cluster, valid = (torch.from_numpy(a).to(DEVICE)
                                  for a in arrays[:3])
        query = None if arrays[3] is None else torch.from_numpy(
            arrays[3]).to(DEVICE)
        b, n = cluster.shape
        run = lambda: boundary_distances_all(coords, cluster, valid, query)
        plain = lambda: boundary_distances_all_reference(coords, cluster,
                                                         valid, query)
        pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
        d = boundary_distances_all(coords, cluster, valid, query, pairs=pairs)
        ref = plain()
        torch.cuda.synchronize()
        tag = f"boundary_distances_all ({role}) {b}x{n}"
        check(torch.equal(d, ref), f"{tag}: kernel differs from the plain "
                                   f"version in {int((d != ref).sum())} rows")
        n_pairs, n_all = int(pairs), all_pairs(valid, query)
        check(n_pairs <= n_all, f"{tag}: {n_pairs} pairs > all {n_all}")
        big = b * n >= 100000
        b_ms, b_by = bound_ms(*distance_work(cluster, valid, query),
                              peak=PEAK_FP32_FLOPS)
        row = dict(kernel="boundary_distances_all", role=role,
                   shape=f"{b}x{n}", count=count, valid_keys=int(valid.sum()),
                   query_rows=b * n if query is None else int(query.sum()),
                   finite=int(torch.isfinite(d).sum()), max_abs_err=0.0,
                   bitwise_equal=True, pairs=n_pairs, all_pairs=n_all,
                   pairs_share=n_pairs / n_all if n_all else None,
                   ms=None,
                   plain_ms=time_ms(torch, plain, reps=2 if big else 5,
                                    warmup=0),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   parent_ms=None)
        timed = lambda f: time_ms(torch, f, reps=5 if big else 10, warmup=1)
        if parent is not None and (query is None or parent[1]):
            prun = lambda: parent[0](coords, cluster, valid, query)
            pd = prun()
            torch.cuda.synchronize()
            check(torch.equal(pd, ref), f"{tag}: the parent's kernel differs "
                                        f"from the plain version")
            # in turns: parent, change, change, parent
            t = [timed(f) for f in (prun, run, run, prun)]
            row.update(parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2)
        else:
            row["ms"] = timed(run)
        emit({"phase": "kernel_parity", **row})
        rows.append(row)
        del coords, cluster, valid, query, d, ref
        torch.cuda.empty_cache()
    check([r["finite"] for r in rows if r["role"] in ("all invalid",
                                                      "one cluster")]
          == [0, 0], "rows with no key of another cluster must be inf")
    check(all(r["finite"] <= r["query_rows"] for r in rows),
          "rows outside the query must be inf")
    return rows


def phase_round0(torch, eval_batch):
    """Round 0 of the device eval on the smoke scene: its distance call
    (every object row queried) timed with the pairs it evaluated against
    the all-pairs count, beside the plain torch distance that the host
    loops run (``engine/clicks.py::boundary_distances``), bit for bit on
    the object rows; then ``round0_clicks`` against ``simulate_clicks``
    (the same clicks, in the same shuffled order) and the wall time of
    each."""
    from agile3d_torch.engine.clicks import boundary_distances, simulate_clicks
    from agile3d_torch.engine.device_eval import round0_clicks
    from agile3d_torch.ops.boundary_dist import (
        all_pairs,
        boundary_distances_all,
    )

    coords, cluster, valid = (torch.from_numpy(a[0]).to(DEVICE)
                              for a in rollout_inputs(eval_batch))
    labels = torch.from_numpy(eval_batch.labels[0]).to(DEVICE)
    nv = int(valid.sum())
    labels_host = eval_batch.labels[0, :nv]
    num_obj = int(eval_batch.num_obj[0])
    query = cluster >= 0
    err_rows = torch.nonzero(query).reshape(-1)
    args = (coords[None], cluster[None], valid[None])
    pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    d = boundary_distances_all(*args, query=query[None], pairs=pairs)[0]
    ones = torch.ones(nv, dtype=torch.bool, device=DEVICE)
    plain = lambda: boundary_distances(coords[:nv], cluster[:nv], ones,
                                       err_rows)
    ref = plain()
    torch.cuda.synchronize()
    check(torch.equal(d[err_rows], ref) and torch.isinf(d[~query]).all(),
          f"round 0: the kernel differs from the host loops' distance in "
          f"{int((d[err_rows] != ref).sum())} rows")
    clicks = lambda: round0_clicks(coords, valid, labels, labels_host,
                                   num_obj=num_obj, rng=random.Random(42))
    host = lambda: simulate_clicks(
        np.zeros(nv, np.int32), labels_host, eval_batch.raw[:nv],
        num_obj=num_obj, training=False, current_num_clicks=0,
        rng=random.Random(42), device=DEVICE)
    got, want = clicks(), host()
    check(all(np.array_equal(a, b) for a, b in zip(got, want))
          and len(got.vox) == num_obj,
          f"round 0: the device eval's clicks {got} are not the host "
          f"loops' {want}")
    n_pairs, n_all = int(pairs), all_pairs(valid[None], query[None])
    row = dict(phase="round0", rows=int(valid.shape[0]), valid_rows=nv,
               query_rows=int(query.sum()), clusters=num_obj,
               pairs=n_pairs, all_pairs=n_all, pairs_share=n_pairs / n_all,
               ms=time_ms(torch, lambda: boundary_distances_all(
                   *args, query=query[None])),
               plain_ms=time_ms(torch, plain, reps=2, warmup=0),
               clicks_wall_ms=wall_ms(torch, clicks),
               simulate_clicks_wall_ms=wall_ms(torch, host, reps=2))
    emit(row)
    check(n_pairs <= n_all, f"round 0: {n_pairs} pairs > all {n_all}")
    return row


@contextlib.contextmanager
def native_host_prep(path: str, numpy_too: bool = False):
    """Counts the pyramids built and the point clouds quantized in the
    block by path, emits them, and fails if the block built none on the
    native runtime or (unless ``numpy_too``) any on the numpy path."""
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    for f in (build_pyramid, sparse_quantize):
        f.paths = {"native": 0, "numpy": 0}
    yield
    counts = {"pyramids": dict(build_pyramid.paths),
              "quantized": dict(sparse_quantize.paths)}
    emit({"phase": "host_prep", "path": path, **counts})
    check(counts["pyramids"]["native"] > 0,
          f"{path}: no pyramid built on the native runtime: {counts}")
    check(numpy_too or (counts["pyramids"]["numpy"] == 0
                        and counts["quantized"]["numpy"] == 0),
          f"{path}: host prep took the numpy path: {counts}")


def phase_probes(torch, eval_pyr, eval_dev):
    """The probes' kernels against their plain versions on the card, then
    the probe entry points with the launches counted. ``eval_pyr`` is the
    smoke scene's pyramid on the host, ``eval_dev`` the same on the card."""
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_reference
    from agile3d_torch.ops.banded_window import (
        banded_window_conv,
        banded_window_conv_reference,
        max_window_rows,
        window_layout,
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
        plan = window_plan(lv.k3, max_rows=max_window_rows(k, 96))
        stats = window_stats(lv.k3, plan)
        slots, staged, slot_rows = window_layout(k, 96, plan.max_length)
        emit({"phase": "probe_plan", "rows": n, **stats,
              "layout": {"window_slots": slots, "indices_staged": staged,
                         "slot_rows": slot_rows}})
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

    # the row gather at the TPU probe's shape, 27 x 1024 rows, from a table
    # that fits one CTA's shared memory and from the TPU probe's own table
    # (a 16-CTA cluster's): exact, timed; beside them the least time a call
    # shows here (a 16-byte zero_) and the output's bytes written alone
    # (fill_)
    c, m = probe_smem_gather.CHANNELS, probe_smem_gather.GATHERS
    tiny = torch.zeros(4, device=DEVICE)
    filled = torch.empty((m, c), device=DEVICE)
    floor_ms = time_ms(torch, lambda: tiny.zero_())
    store_ms = time_ms(torch, lambda: filled.fill_(1.0))
    del tiny, filled
    for w_rows in (probe_smem_gather.SMEM_ROWS, probe_smem_gather.TPU_ROWS):
        x = torch.rand((w_rows, c), generator=g, device=DEVICE)
        idx = torch.randint(0, w_rows, (m,), generator=g, device=DEVICE,
                            dtype=torch.int32)
        ref = row_gather_reference(x, idx)
        out = smem_row_gather(x, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"smem_row_gather ({w_rows} rows) differs from x[idx]")
        b_ms, b_by = bound_ms(*gather_work(w_rows, c, m))
        row = dict(kernel="smem_row_gather", role="probe shape", rows=m,
                   cin=c, cout=c, count=1, table_rows=w_rows, max_abs_err=0.0,
                   ms=time_ms(torch, lambda: smem_row_gather(x, idx)),
                   floor_ms=floor_ms, store_ms=store_ms,
                   plain_ms=time_ms(torch, lambda: row_gather_reference(x, idx)),
                   library_ms=time_ms(torch,
                                      lambda: torch.index_select(x, 0, idx)),
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "probe_parity", **row})
        rows.append(row)
        del x, idx, out, ref
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
    check(gather["a_equal"] and gather["a2_equal"],
          "probe: smem_row_gather differs from x[idx]")
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

    # the bf16 decoder policy on the card against the same on the CPU, both
    # fed the CPU's f32 scene features (the CPU tests hold the CPU's bf16
    # decoder against JAX's)
    with torch.no_grad():
        scene = model.forward_backbone(
            to_device(batch.pyramid, "cpu"),
            *(torch.from_numpy(a) for a in (batch.feats, batch.raw,
                                            batch.sample_idx)))
        model.cfg = gpu.cfg = dataclasses.replace(model.cfg,
                                                  decoder_dtype="bfloat16")
        no = torch.tensor([num_obj], dtype=torch.int32)
        out = model.forward_mask(scene, clicks, no)
        want16 = out["pred_masks"][0, :n_valid, :num_obj + 1].float()
        got16 = gpu.forward_mask(
            type(scene)(*(t.to(DEVICE) for t in scene)),
            type(clicks)(*(t.to(DEVICE) for t in clicks)), no.to(DEVICE))[
            "pred_masks"][0, :n_valid, :num_obj + 1].float().cpu()
    scale16 = float(want16.abs().max()) + 1.0
    err16 = float((got16 - want16).abs().max())
    agree16 = float((got16.argmax(-1) == want16.argmax(-1)).float().mean())
    row = {"phase": "reference", "rows": batch.pyramid.levels[0].grid.shape[0],
           "num_valid": n_valid, "launches_k3": launches[0],
           "launches_stem": launches[1], "logit_scale": scale,
           "plain_max_abs_err": err_plain, "plain_label_agree": agree_plain,
           "kernel_max_abs_err": err_kern, "kernel_label_agree": agree_kern,
           "attn_chunk": out["attn_chunk"],
           "bf16_decoder_max_abs_err": err16, "bf16_logit_scale": scale16,
           "bf16_decoder_label_agree": agree16,
           "seconds": time.time() - t0}
    emit(row)
    check(err16 <= 2e-2 * scale16 and agree16 >= 0.99,
          f"bf16 decoder, card vs CPU: {err16} (scale {scale16}), labels "
          f"agree {agree16}")
    # level 0 of this scene is a 49,152-row bucket: the stem and the four k3
    # convs of block8 take the kernels, level 1 is below the threshold
    check(launches == (4, 1), f"reference run launches {launches} != (4, 1)")
    # f32 on both sides, summed in other orders
    check(err_plain <= 1e-3 * scale, f"card f32 vs CPU f32: {err_plain}")
    check(agree_plain >= 0.999, f"card f32 labels agree {agree_plain}")
    # the kernels round their operands to bf16 (8-bit mantissa)
    check(err_kern <= 5e-2 * scale, f"card kernels vs CPU f32: {err_kern}")
    check(agree_kern >= 0.99, f"card kernel labels agree {agree_kern}")


def phase_decoder(torch, batch):
    """``forward_mask`` on the smoke scene at full width, dense and chunked
    (the chunk as JAX's rule picks it), in f32 and bf16: CUDA-event time
    (median of 5, behind the spin kernel), host-clock time through a
    synchronize, and peak memory, in one call; chunked against dense at f32
    within 1e-4 x (max + 1), bf16 against f32 by argmax agreement. Then one
    chunked forward per dtype at a KITTI-360-size shape, scene features
    made from seeded tensors (no backbone), with its peak memory."""
    from agile3d_torch.config import Config
    from agile3d_torch.models.agile3d import ClickState, SceneFeatures
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.sparse.grid import to_device

    t0 = time.time()
    cfg = Config().model
    model = init_agile3d(cfg, seed=0, device=DEVICE)
    with torch.no_grad():
        scene = model.forward_backbone(
            to_device(batch.pyramid, DEVICE),
            *(torch.from_numpy(a).to(DEVICE)
              for a in (batch.feats, batch.raw, batch.sample_idx)))
    n_valid = int((batch.sample_idx[0] >= 0).sum())
    num_obj = int(batch.num_obj[0])
    clicks = ClickState(*(t.to(DEVICE) for t in _clicks(
        torch, batch.labels[0, :n_valid], num_obj)))
    no = torch.tensor([num_obj], dtype=torch.int32, device=DEVICE)
    # the bf16 policy casts the scene once, in forward_backbone
    scenes = {"float32": scene,
              "bfloat16": scene._replace(
                  mask_feat=scene.mask_feat.to(torch.bfloat16),
                  pos_pcd=scene.pos_pcd.to(torch.bfloat16))}

    def measure(sc, c, n):
        run = lambda: model.forward_mask(sc, c, n)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = time_ms(torch, run)
            wall = wall_ms(torch, run)
        return out, dict(chunk=out["attn_chunk"], ms=ms, wall_ms=wall,
                         peak_gib=peak / 2 ** 30,
                         peak_above_inputs_gib=(peak - base) / 2 ** 30)

    forms, masks = {}, {}
    for dtype in ("float32", "bfloat16"):
        for form, threshold in (("dense", 2 ** 62),
                                ("chunked", cfg.attn_dense_threshold)):
            model.cfg = dataclasses.replace(cfg, decoder_dtype=dtype,
                                            attn_dense_threshold=threshold)
            out, row = measure(scenes[dtype], clicks, no)
            masks[form, dtype] = out["pred_masks"][0, :n_valid,
                                                   :num_obj + 1].float()
            forms[f"{form}_{dtype}"] = row
            del out
    dense, chunked = masks["dense", "float32"], masks["chunked", "float32"]
    scale = float(dense.abs().max()) + 1.0
    chunk_err = float((chunked - dense).abs().max())
    labels = chunked.argmax(-1)
    agree = {form: float((masks[form, "bfloat16"].argmax(-1)
                          == masks[form, "float32"].argmax(-1))
                         .float().mean()) for form in ("dense", "chunked")}
    out_dtypes = {str(m.dtype) for m in masks.values()}
    del masks, dense, chunked, labels, scenes, scene
    torch.cuda.empty_cache()

    # KITTI-360 size: ~670,000 valid rows of the 786,432-row bucket, 256
    # clicks over 8 objects; seeded features in the scene's value ranges
    g = torch.Generator(device=DEVICE).manual_seed(0)
    n, c = KITTI_ROWS, cfg.hidden_dim
    valid = torch.zeros((1, n), dtype=torch.bool, device=DEVICE)
    valid[0, :KITTI_VALID] = True
    raw = torch.rand((1, n, 3), generator=g, device=DEVICE) * 60.0
    raw = torch.where(valid[..., None], raw, 0.0)
    big = SceneFeatures(
        mask_feat=torch.where(valid[..., None], torch.randn(
            (1, n, c), generator=g, device=DEVICE), 0.0),
        pos_pcd=torch.where(valid[..., None], torch.rand(
            (1, n, c), generator=g, device=DEVICE) * 2 - 1, 0.0),
        vox_valid=valid, raw=raw, cmin=raw[0, :KITTI_VALID].amin(0)[None],
        cmax=raw[0, :KITTI_VALID].amax(0)[None])
    rows = torch.randperm(KITTI_VALID, generator=g, device=DEVICE)
    big_clicks = ClickState(
        rows[:KITTI_CLICKS].to(torch.int32)[None],
        (torch.arange(KITTI_CLICKS, device=DEVICE, dtype=torch.int32)
         % 9)[None],
        torch.arange(KITTI_CLICKS, device=DEVICE, dtype=torch.int32)[None])
    eight = torch.tensor([8], dtype=torch.int32, device=DEVICE)
    kitti = {}
    for dtype in ("float32", "bfloat16"):
        model.cfg = dataclasses.replace(cfg, decoder_dtype=dtype)
        sc = big if dtype == "float32" else big._replace(
            mask_feat=big.mask_feat.to(torch.bfloat16),
            pos_pcd=big.pos_pcd.to(torch.bfloat16))
        out, row = measure(sc, big_clicks, eight)
        row["finite"] = bool(torch.isfinite(
            out["pred_masks"][0, :KITTI_VALID, :9]).all())
        kitti[dtype] = row
        del out, sc
    q = cfg.num_bg_queries + KITTI_CLICKS
    dense_logits_gib = cfg.num_heads * q * n * 4 / 2 ** 30
    del big, big_clicks, rows, raw, valid, model
    torch.cuda.empty_cache()

    emit({"phase": "decoder", "rows": batch.sample_idx.shape[1],
          "num_valid": n_valid, "queries": cfg.num_bg_queries
          + clicks.vox.shape[1], "forms": forms,
          "chunked_vs_dense_f32_max_abs_err": chunk_err, "logit_scale": scale,
          "bf16_vs_f32_label_agree": agree, "mask_dtypes": sorted(out_dtypes),
          "kitti": {"rows": n, "num_valid": KITTI_VALID, "queries": q,
                    "dense_logits_gib_per_tensor": dense_logits_gib,
                    **kitti},
          "seconds": time.time() - t0})
    check(all(forms[f"dense_{d}"]["chunk"] == 0 for d in ("float32",
                                                          "bfloat16")),
          f"the dense forms chunked: {forms}")
    check(all(forms[f"chunked_{d}"]["chunk"] == 32768
              for d in ("float32", "bfloat16")),
          f"the smoke scene's chunk is not 32768 (6 steps): {forms}")
    check(chunk_err <= 1e-4 * scale,
          f"chunked vs dense decoder, f32: {chunk_err} > 1e-4 x {scale}")
    check(out_dtypes == {"torch.float32"}, f"mask dtypes {out_dtypes}")
    check(min(agree.values()) >= 0.99,
          f"bf16 vs f32 decoder labels agree {agree}")
    check(all(k["chunk"] == 32768 and k["finite"] for k in kitti.values()),
          f"KITTI-size chunked forward: {kitti}")
    return forms


def _eval_run(torch, scans, val_list, out_dir, host_rollout: bool):
    """One run of the eval entry point, with the kernels' launches counted
    around it and the backbone, the decoder calls (host loop) and the
    device rounds timed with CUDA events. Returns what it measured."""
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.engine import device_eval
    from agile3d_torch.engine import eval as peval
    from agile3d_torch.ops.banded_conv import banded_conv
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.boundary_dist import boundary_distances_all
    from agile3d_torch.ops.row_gather import smem_row_gather

    events = {"backbone": [], "mask": [], "rounds": []}
    seen = {}
    orig = {"backbone": peval.InteractiveEngine.run_backbone,
            "mask": peval.InteractiveEngine.run_mask,
            "rounds": device_eval.rollout_rounds}

    def timed(key, method=True):
        def wrapper(*args, **kwargs):
            if method:
                seen["engine"] = args[0]
            if key == "backbone":
                seen["batch"] = args[1]
            if key == "rounds":
                seen["widths"] = list(args[-2])
            if key == "mask":  # the click bucket the host loop's decoder sees
                seen.setdefault("widths", []).append(
                    args[0]._click_bucket(args[2].count))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig[key](*args, **kwargs)
            end.record()
            events[key].append((start, end))
            return out
        return wrapper

    peval.InteractiveEngine.run_backbone = timed("backbone")
    peval.InteractiveEngine.run_mask = timed("mask")
    device_eval.rollout_rounds = timed("rounds", method=False)
    argv = (["--scan_folder", scans, "--val_list", val_list, "--seed", "0",
             "--max_num_clicks", str(MAX_NUM_CLICKS), "--output_dir", out_dir,
             "--device", DEVICE] + REFERENCE_BLOCK
            + (["--host_rollout"] if host_rollout else []))
    args = eval_multi_obj.get_args_parser().parse_args(argv)
    logged = []

    def log(msg):
        logged.append(msg)
        print(f"eval_multi_obj: {msg}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        banded_conv.launches = banded_stem_conv.launches = 0
        banded_window_conv.launches = smem_row_gather.launches = 0
        boundary_distances_all.launches = 0
        with chunks_seen() as chunks:
            results = eval_multi_obj.main(args, log=log)
        torch.cuda.synchronize()
        launches = {"banded_conv": banded_conv.launches,
                    "banded_stem": banded_stem_conv.launches,
                    "banded_window_conv": banded_window_conv.launches,
                    "smem_row_gather": smem_row_gather.launches,
                    "boundary_distances_all": boundary_distances_all.launches}
    finally:
        peval.InteractiveEngine.run_backbone = orig["backbone"]
        peval.InteractiveEngine.run_mask = orig["mask"]
        device_eval.rollout_rounds = orig["rounds"]
    wall_s = time.time() - t0

    csv = os.path.join(out_dir, "val_results_multi.csv")
    rows = [r.split(" ") for r in open(csv).read().strip().split("\n") if r]
    ious = [float(r[4]) for r in rows]
    tag = "host rollout" if host_rollout else "device rollout"
    n_bb = len(events["backbone"])
    check(len(rows) > 0 and all(len(r) == 5 for r in rows),
          f"{tag}: no CSV rows")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in ious),
          f"{tag}: IoUs not finite in [0, 1]: {ious}")
    check(isinstance(results, dict) and results and results in logged,
          f"{tag}: the evaluator dict was not printed")
    check(n_bb == 1, f"{tag}: {n_bb} backbone calls")
    check(launches["banded_conv"] == 8 * n_bb,
          f"{tag}: k3 kernel launches {launches['banded_conv']} != 8 x {n_bb}")
    check(launches["banded_stem"] == 1 * n_bb,
          f"{tag}: stem kernel launches {launches['banded_stem']} != {n_bb}")
    check(launches["banded_window_conv"] == launches["smem_row_gather"] == 0,
          f"{tag}: a probe kernel ran on the eval path: {launches}")
    rounds = len(rows) - 1  # the rows after round 0's
    if host_rollout:
        check(len(events["mask"]) >= 1 and not events["rounds"],
              f"{tag}: {len(events['mask'])} decoder calls")
        check(launches["boundary_distances_all"] == 0,
              f"{tag}: the distance kernel ran on the host loop")
    else:
        check(not events["mask"] and len(events["rounds"]) == 1
              and len(seen["widths"]) == rounds,
              f"{tag}: {len(events['rounds'])} device rollouts")
        # round 0's call, then one a round
        check(launches["boundary_distances_all"] == rounds + 1,
              f"{tag}: distance kernel launches "
              f"{launches['boundary_distances_all']} != {rounds} rounds + 1")
    elapsed = lambda pairs: [a.elapsed_time(b) for a, b in pairs]
    return dict(rows=rows, ious=ious, launches=launches, wall_s=wall_s,
                results=results, rounds=rounds, chunks=chunks,
                backbone_first_ms=elapsed(events["backbone"])[0],
                mask_ms=elapsed(events["mask"]),
                rounds_ms=sum(elapsed(events["rounds"])),
                widths=seen["widths"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                engine=seen["engine"], batch=seen["batch"])


def phase_main_path(torch, scans, val_list, out_dir):
    """The eval entry point on the smoke scene: the default device rollout,
    then the host loop; the two CSVs must give the same rows (ID, scene,
    object and click columns equal, IoUs within 1e-5)."""
    dev = _eval_run(torch, scans, val_list, os.path.join(out_dir, "device"),
                    host_rollout=False)
    host = _eval_run(torch, scans, val_list, os.path.join(out_dir, "host"),
                     host_rollout=True)
    check(len(dev["rows"]) == len(host["rows"])
          and [r[:4] for r in dev["rows"]] == [r[:4] for r in host["rows"]],
          "device and host rollouts wrote other rows")
    iou_diff = max(abs(a - b) for a, b in zip(dev["ious"], host["ious"]))
    check(iou_diff <= 1e-5, f"device vs host rollout IoU differs by "
                            f"{iou_diff}")
    # the decoder's click-table width round by round: the budget crosses a
    # bucket, and the device rounds see the host loop's (which stops calling
    # the decoder once the scene converges)
    widths = {"device": dev["widths"], "host": host["widths"]}
    check(len(set(widths["host"])) > 1,
          f"the click budget crosses no bucket: {widths['host']}")
    check(widths["device"][:len(widths["host"])] == widths["host"],
          f"the device rounds saw other click buckets: {widths}")

    # steady backbone: the same batch again, after the counts were read
    engine, batch = dev["engine"], dev["batch"]
    bb_ms = time_ms(torch, lambda: engine.run_backbone(batch), reps=5,
                    warmup=1)
    pyr = batch.pyramid
    emit({"phase": "main_path", "levels": [lv.num_valid for lv in pyr.levels],
          "rows": [lv.grid.shape[0] for lv in pyr.levels],
          "csv_rows": len(dev["rows"]), "rounds": dev["rounds"],
          "click_buckets": {w: widths["device"].count(w)
                            for w in sorted(set(widths["device"]))},
          "launches": dev["launches"], "launches_host": host["launches"],
          "attn_chunks": dev["chunks"], "attn_chunks_host": host["chunks"],
          "backbone_first_ms": dev["backbone_first_ms"], "backbone_ms": bb_ms,
          "device_rounds_ms": dev["rounds_ms"],
          "device_ms_per_round": dev["rounds_ms"] / dev["rounds"],
          "mask_ms_median": statistics.median(host["mask_ms"]),
          "mask_ms_first": host["mask_ms"][0],
          "peak_mem_gib": max(dev["peak_gib"], host["peak_gib"]),
          "final_iou": dev["ious"][-1], "iou_max_diff": iou_diff,
          "wall_s": dev["wall_s"], "wall_s_host": host["wall_s"],
          "evaluator": {k: finite(v) for k, v in dev["results"].items()}})
    # 42 queries x 196,608 rows x 8 heads (74 queries past the 32-click
    # bucket) exceed the dense threshold: JAX's rule picks 32,768, 6 chunks
    check(set(dev["chunks"]) == set(host["chunks"]) == {32768},
          f"attention chunks {dev['chunks']}, host {host['chunks']}")
    return dev["launches"]


def _single_run(torch, scans, objects, out_dir, host_rollout: bool):
    """One run of the single-object entry point, launches counted around
    it, the backbone and the device rounds (or the host loop's decoder
    calls) timed with CUDA events."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import eval_single_obj
    from agile3d_torch.engine import device_eval
    from agile3d_torch.engine import eval as peval

    argv = ["--scan_folder", scans, "--val_list", objects, "--seed", "0",
            "--output_dir", out_dir, "--device", DEVICE]
    args = eval_single_obj.get_args_parser().parse_args(
        argv + (["--host_rollout"] if host_rollout else []))
    logged = []
    bb, rounds, masks = [], [], []
    t0 = time.time()
    with timed_calls(torch, peval.InteractiveEngine, "run_backbone", bb), \
            timed_calls(torch, device_eval, "rollout_rounds", rounds), \
            timed_calls(torch, peval.InteractiveEngine, "run_mask", masks), \
            chunks_seen() as chunks:
        zero_launches()
        results = eval_single_obj.main(args, log=logged.append)
        torch.cuda.synchronize()
        launches = kernel_launches()
    wall_s = time.time() - t0
    csv = os.path.join(out_dir, "val_results_single.csv")
    rows = [r.split(" ") for r in open(csv).read().strip().split("\n") if r]
    elapsed = lambda pairs: [a.elapsed_time(b) for a, b in pairs]
    return dict(rows=rows, ious=[float(r[4]) for r in rows], csv=csv,
                launches=launches, results=results, logged=logged,
                wall_s=wall_s, chunks=chunks, backbones=len(bb),
                backbone_ms=elapsed(bb), rounds_ms=sum(elapsed(rounds)),
                mask_ms=elapsed(masks))


def phase_single(torch, scans, tmp):
    """``python -m agile3d_torch.eval_single_obj`` (in process) on the
    smoke scene's first SINGLE_OBJECTS objects at the default 20-click
    budget: the device rollout, then ``--host_rollout``; the rows must be
    equal, each object one backbone (8 k3 and 1 stem launches) and one
    distance launch for its round 0 and each device round; ``EvaluatorSO``
    finite; then
    ``python -m agile3d_torch.compute_ap`` on the CSV."""
    from agile3d_torch import compute_ap

    objects = os.path.join(tmp, "smoke_objects.npy")
    np.save(objects, np.array([["scene0000_00", str(o)]
                               for o in range(1, SINGLE_OBJECTS + 1)]))
    dev = _single_run(torch, scans, objects, os.path.join(tmp, "single_dev"),
                      host_rollout=False)
    host = _single_run(torch, scans, objects,
                       os.path.join(tmp, "single_host"), host_rollout=True)
    n_rows = SINGLE_OBJECTS * 21
    iou_diff = max(abs(a - b) for a, b in zip(dev["ious"], host["ious"]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ap = compute_ap.main(types.SimpleNamespace(result_file=dev["csv"]))
    ap_values = [v for row in ap.values() for v in row.values()]
    rounds = n_rows - SINGLE_OBJECTS
    emit({"phase": "single", "objects": SINGLE_OBJECTS,
          "csv_rows": len(dev["rows"]), "rounds": rounds,
          "launches": dev["launches"], "launches_host": host["launches"],
          "attn_chunks": dev["chunks"], "attn_chunks_host": host["chunks"],
          "backbone_ms": dev["backbone_ms"],
          "device_rounds_ms": dev["rounds_ms"],
          "device_ms_per_round": dev["rounds_ms"] / rounds,
          "host_mask_ms_median": statistics.median(host["mask_ms"]),
          "wall_s": dev["wall_s"], "wall_s_host": host["wall_s"],
          "iou_max_diff": iou_diff,
          "final_ious": [dev["ious"][i * 21 + 20]
                         for i in range(SINGLE_OBJECTS)],
          "evaluator": {k: finite(v) for k, v in dev["results"].items()},
          "ap": {k: ap[k] for k in (1, 5, 10, 20)},
          "compute_ap_lines": len(buf.getvalue().splitlines())})
    for tag, r in (("device rollout", dev), ("host rollout", host)):
        check(len(r["rows"]) == n_rows and all(len(x) == 5 for x in r["rows"]),
              f"single, {tag}: {len(r['rows'])} rows != {n_rows}")
        check(r["backbones"] == SINGLE_OBJECTS,
              f"single, {tag}: {r['backbones']} backbone calls")
        check(r["launches"]["banded_conv"] == 8 * SINGLE_OBJECTS
              and r["launches"]["banded_stem"] == SINGLE_OBJECTS,
              f"single, {tag}: launches {r['launches']}")
        check(r["launches"]["banded_window_conv"]
              == r["launches"]["smem_row_gather"]
              == r["launches"]["banded_conv_dw"] == 0,
              f"single, {tag}: a kernel of another path ran: {r['launches']}")
        check(r["results"] in r["logged"] and all(
            math.isfinite(v) for v in r["results"].values()),
              f"single, {tag}: evaluator {r['results']}")
        check(set(r["chunks"]) == {32768},
              f"single, {tag}: attention chunks {r['chunks']}")
    check([r[:4] for r in dev["rows"]] == [r[:4] for r in host["rows"]]
          and [r[3] for r in dev["rows"][:21]] == [str(k) for k in range(21)],
          "single: device and host rollouts wrote other rows")
    check(iou_diff <= 1e-5, f"single: device vs host IoU differs by "
                            f"{iou_diff}")
    # each object's round 0, then one a round
    check(dev["launches"]["boundary_distances_all"]
          == rounds + SINGLE_OBJECTS
          and host["launches"]["boundary_distances_all"] == 0,
          f"single: distance launches {dev['launches']} / {host['launches']}"
          f" != {rounds} + {SINGLE_OBJECTS} / 0")
    check(sorted(ap) == list(range(1, 21)) and all(
        math.isfinite(v) and 0.0 <= v <= 1.0 for v in ap_values)
          and "Results for 20 clicks." in buf.getvalue(),
          f"compute_ap: {ap}")
    return {k: dev["launches"][k] + host["launches"][k]
            for k in dev["launches"]}


def _write_interactive_scene(scans, root):
    """The smoke scan in the annotation tool's layout:
    ``<root>/scene_smoke/{scan,label}.ply``."""
    from agile3d_torch.data.ply import read_ply, write_ply

    pc = read_ply(os.path.join(scans, "scene0000_00.ply"))
    d = os.path.join(root, "scene_smoke")
    os.makedirs(d)
    xyz = {k: pc[k] for k in ("x", "y", "z")}
    write_ply(os.path.join(d, "scan.ply"),
              {**xyz, **{k: pc[k] for k in ("R", "G", "B")}})
    write_ply(os.path.join(d, "label.ply"), {**xyz, "label": pc["label"]})
    return root


def _scripted_clicks(labels, n: int):
    """``n`` clicks as an annotator would give them: the objects in turn,
    then the background, each time on another voxel of that object."""
    ids = [o for o in range(1, int(labels.max()) + 1) if (labels == o).any()]
    ids.append(0)
    click_idx, times, sets = {"0": []}, {"0": []}, []
    for t in range(n):
        o = ids[t % len(ids)]
        rows = np.nonzero(labels == o)[0]
        row = int(rows[(t // len(ids)) * 7919 % len(rows)])
        click_idx.setdefault(str(o), []).append(row)
        times.setdefault(str(o), []).append(t)
        sets.append(({k: list(v) for k, v in click_idx.items()},
                     {k: list(v) for k, v in times.items()}))
    return sets


def _post_click(base, click_idx, times):
    req = urllib.request.Request(
        base + "/click", method="POST",
        data=json.dumps({"click_idx": click_idx,
                         "click_time_idx": times}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read(), dict(r.headers)


def phase_serve(torch, scans, tmp):
    """The annotation server on the smoke scene, at bf16 (the serving
    default) and at f32: the scene load (launches: 8 k3 and 1 stem), a
    scripted session of SERVE_CLICKS clicks (per-click wall time and
    CUDA-event decoder time, p50 / p90; launches: 0), and at bf16 one
    ``POST /click`` through the HTTP front end on localhost. The p50 is
    printed beside SERVE_LIMIT_MS, not held to it."""
    from agile3d_torch.utils.profiling import kernel_launches
    from http.server import ThreadingHTTPServer

    from agile3d_torch.config import Config, ModelConfig
    from agile3d_torch.interactive import (
        InteractiveDataLoader,
        InteractiveSegmentationServer,
    )
    from agile3d_torch.interactive.web import make_handler

    root = _write_interactive_scene(scans, os.path.join(tmp, "interactive"))
    rows, total = {}, {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.time()
        cfg = Config(model=dataclasses.replace(ModelConfig(),
                                               decoder_dtype=dtype))
        zero_launches()
        server = InteractiveSegmentationServer(
            InteractiveDataLoader(root, f"smoke_{dtype}"), cfg=cfg,
            device=DEVICE, seed=0)
        torch.cuda.synchronize()
        start_s = time.time() - t0
        start_launches = kernel_launches()
        zero_launches()
        t0 = time.time()
        server.load_scene(0)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        load_launches = kernel_launches()

        sets = _scripted_clicks(server.sample.labels, SERVE_CLICKS)
        decoder, wall, ious = [], [], []
        zero_launches()
        with timed_calls(torch, server.engine.model, "forward_mask", decoder):
            for click_idx, times in sets:
                t0 = time.perf_counter()
                pred_full, iou = server.get_next_click(click_idx, times)
                wall.append(1e3 * (time.perf_counter() - t0))
                ious.append(iou)
        click_launches = kernel_launches()
        decoder_ms = [a.elapsed_time(b) for a, b in decoder]
        row = {"scene_rows": server.scene.mask_feat.shape[1],
               "num_valid": server.n_valid, "points": len(pred_full),
               "mask_dtype": str(server.scene.mask_feat.dtype),
               "start_s": start_s, "scene_load_s": load_s,
               "launches_start": start_launches,
               "launches_scene_load": load_launches,
               "launches_clicks": click_launches,
               "click_wall_ms": wall, "click_decoder_ms": decoder_ms,
               "wall_p50_ms": percentile(wall, 50),
               "wall_p90_ms": percentile(wall, 90),
               "decoder_p50_ms": percentile(decoder_ms, 50),
               "decoder_p90_ms": percentile(decoder_ms, 90),
               "limit_ms": SERVE_LIMIT_MS,
               "wall_p50_within_limit": percentile(wall, 50) <= SERVE_LIMIT_MS,
               "ious": ious}
        for tag, got in (("server start", start_launches),
                         ("scene load", load_launches)):
            check(got["banded_conv"] == 8 and got["banded_stem"] == 1
                  and sum(got.values()) == 9,
                  f"serve {dtype}, {tag}: launches {got}")
        check(sum(click_launches.values()) == 0,
              f"serve {dtype}: a kernel ran on the click path: "
              f"{click_launches}")
        check(len(decoder_ms) == SERVE_CLICKS and all(
            iou is not None and 0.0 <= iou <= 1.0 for iou in ious),
              f"serve {dtype}: decoder calls {len(decoder_ms)}, IoUs {ious}")
        check(len(pred_full) == len(server.loader.coords),
              f"serve {dtype}: {len(pred_full)} labels")
        if dtype == "bfloat16":
            httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                        make_handler(server))
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                click_idx, times = sets[-1]
                t0 = time.perf_counter()
                status, body, headers = _post_click(
                    f"http://127.0.0.1:{httpd.server_address[1]}",
                    click_idx, times)
                http_ms = 1e3 * (time.perf_counter() - t0)
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=60)
            check(not thread.is_alive(), "the HTTP server did not stop")
            labels = np.frombuffer(body, np.uint8)
            check(status == 200 and len(labels) == server.n_valid
                  and headers.get("X-IoU") == f"{ious[-1]:.4f}",
                  f"POST /click: {status}, {len(labels)} labels, "
                  f"X-IoU {headers.get('X-IoU')} vs {ious[-1]:.4f}")
            row["http"] = {"status": status, "round_trip_ms": http_ms,
                           "x_latency_ms": float(headers["X-Latency-Ms"]),
                           "x_iou": headers["X-IoU"]}
        rows[dtype] = row
        for k, v in (*start_launches.items(), *load_launches.items(),
                     *click_launches.items()):
            total[k] = total.get(k, 0) + v
        del server
        torch.cuda.empty_cache()
    emit({"phase": "serve", **rows})
    return total


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
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
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

    def run(device, banded, backbone_dtype="float32", dropout=0.0,
            seed=None):
        """One supervised step; ``seed`` seeds the dropout generator."""
        mcfg = dataclasses.replace(model0.cfg, backbone_dtype=backbone_dtype,
                                   dropout=dropout)
        model = Agile3D(mcfg)
        model.load_state_dict(model0.state_dict())
        model = model.to(device)
        model.backbone.cfg = dataclasses.replace(model.backbone.cfg,
                                                 banded_conv=banded)
        scfg = dataclasses.replace(cfg, model=mcfg)
        opt, _ = make_optimizer(model, scfg, 1)
        step = make_train_step(scfg, model, opt)
        gen = (None if seed is None
               else torch.Generator(device=device).manual_seed(seed))
        dev_batch = (to_device(batch.pyramid, device),
                     *(torch.from_numpy(a).to(device)
                       for a in (batch.feats, batch.raw, batch.sample_idx)))
        banded_conv.launches = banded_conv_dw.launches = 0
        banded_stem_conv.launches = 0
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if device != "cpu":
            start.record()
        out = step(dev_batch, type(clicks)(*(t.to(device) for t in clicks)),
                   torch.from_numpy(labels).to(device),
                   torch.from_numpy(num_obj).to(device), gen)
        step_ms = peak = None
        if device != "cpu":
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return dict(
            step_ms=step_ms, peak_gib=peak, attn_chunk=out["attn_chunk"],
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
    return run, compare, n_lv


def phase_bf16_backbone(torch, batch, train_run, train_compare, n_lv):
    """``backbone_dtype="bfloat16"`` at full width: the eval
    ``forward_backbone`` on the smoke scene with the kernels on and off
    (launches, FPN dtypes, backbone ms against the f32 backbone's), the
    labels of one ``forward_mask`` after it against the f32 backbone's;
    then one supervised step on the training reference batch with the
    kernels on, held against the CPU's f32 step."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch.config import Config
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv

    t0 = time.time()
    cfg = Config().model
    m32 = init_agile3d(cfg, seed=0, device=DEVICE)
    m16 = Agile3D(dataclasses.replace(cfg, backbone_dtype="bfloat16"))
    m16.load_state_dict(m32.state_dict())
    m16 = m16.to(DEVICE).eval()
    inputs = _model_inputs(torch, batch)
    clicks = _train_clicks(torch, batch.labels, batch.num_obj)
    clicks = type(clicks)(*(t.to(DEVICE) for t in clicks))
    num_obj = torch.from_numpy(batch.num_obj).to(DEVICE)
    kernels_on = m16.backbone.cfg
    with torch.no_grad():
        zero_launches()
        s16 = m16.forward_backbone(*inputs)
        torch.cuda.synchronize()
        launches = kernel_launches()
        fpn = m16.backbone(inputs[0], inputs[1], None,
                           compute_dtype=torch.bfloat16)
        dtypes = [str(f.dtype).replace("torch.", "") for f in fpn]
        del fpn
        m16.backbone.cfg = dataclasses.replace(kernels_on, banded_conv=False)
        zero_launches()
        s16_plain = m16.forward_backbone(*inputs)
        plain_launches = kernel_launches()
        m16.backbone.cfg = kernels_on
        s32 = m32.forward_backbone(*inputs)
        p16 = m16.forward_mask(s16, clicks, num_obj)["pred_masks"].argmax(-1)
        p32 = m32.forward_mask(s32, clicks, num_obj)["pred_masks"].argmax(-1)
        valid = s32.vox_valid
        agree = float((p16 == p32)[valid].float().mean())
        err_plain, scale_plain = _rel(s16.mask_feat, s16_plain.mask_feat)
        err_f32, scale_f32 = _rel(s16.mask_feat, s32.mask_feat)
        ms16 = time_ms(torch, lambda: m16.forward_backbone(*inputs), reps=5)
        ms32 = time_ms(torch, lambda: m32.forward_backbone(*inputs), reps=5)
    del m16, m32, s16, s16_plain, s32, p16, p32
    torch.cuda.empty_cache()

    step = train_run(DEVICE, True, backbone_dtype="bfloat16")
    res = train_compare(step)
    row = {"phase": "bf16_backbone", "eval_launches": launches,
           "eval_plain_launches": plain_launches, "fpn_dtypes": dtypes,
           "mask_feat_kernels_vs_plain": err_plain,
           "mask_feat_plain_scale": scale_plain,
           "mask_feat_vs_f32": err_f32, "mask_feat_f32_scale": scale_f32,
           "labels_agree_vs_f32": agree, "backbone_ms": ms16,
           "backbone_f32_ms": ms32, "train_step_ms": step["step_ms"],
           "train_peak_gib": step["peak_gib"],
           **{f"train_{k}": v for k, v in res.items()},
           "seconds": time.time() - t0}
    emit(row)
    total = {k: v + (dict(zip(("banded_conv", "banded_conv_dw",
                                "banded_stem"), step["launches"])).get(k, 0))
             for k, v in launches.items()}
    check(launches["banded_conv"] == 8 and launches["banded_stem"] == 1,
          f"bf16 eval backbone launches {launches}")
    check(plain_launches["banded_conv"] == plain_launches["banded_stem"] == 0,
          f"kernels off, launches {plain_launches}")
    check(dtypes == ["float32"] * 5, f"bf16 eval FPN dtypes {dtypes}")
    # the kernels round the f32 x of a routed conv to bf16 where the plain
    # conv multiplies it by the bf16 weights in f32
    check(err_plain <= 2e-2 * scale_plain,
          f"bf16 backbone, kernels vs plain: {err_plain} of {scale_plain}")
    check(agree >= 0.95, f"bf16 backbone labels agree {agree} with f32's")
    check(step["launches"] == (8 * n_lv, 4 * n_lv, 0),
          f"bf16 training step launches {step['launches']}")
    check(math.isfinite(res["loss"]) and math.isfinite(res["gnorm"]),
          "bf16 training step: non-finite loss or gnorm")
    # bf16 batch statistics and roundings in every layer turn the step
    # (an earlier call measured 0.734 on the card, 0.729 for the port's
    # bf16 step on the CPU); the limit says only that it points the f32
    # step's way (random directions in 39M dimensions have cosine ~0)
    check(res["grad_cos_all"] >= 0.5,
          f"bf16 training step vs CPU f32: gradient cosine "
          f"{res['grad_cos_all']}")
    return total


def phase_dropout(torch, train_run, n_lv):
    """One supervised step at ``--dropout 0.1`` at full width on the
    training reference batch (kernels on): dense attention (chunk 0) where
    the rate-0 step chunks, a finite loss other than the rate-0 step's, and
    two steps from one generator seed equal; time and peak memory, and the
    logits volume the 524,288-row training batch would hold densely."""
    t0 = time.time()
    rate0 = train_run(DEVICE, True)
    first = train_run(DEVICE, True, dropout=0.1, seed=7)
    again = train_run(DEVICE, True, dropout=0.1, seed=7)
    same = (first["loss"] == again["loss"]
            and all(torch.equal(first["grads"][n], g)
                    for n, g in again["grads"].items()))
    # one dense logits tensor of the main training batch (measured in the
    # train main path): batch 5, 8 heads, 10 background + 64 click
    # queries, 98,304 rows a sample, f32
    dense_gib = 5 * 8 * 74 * 98304 * 4 / 2 ** 30
    row = {"phase": "dropout", "chunk": first["attn_chunk"],
           "rate0_chunk": rate0["attn_chunk"], "loss": first["loss"],
           "rate0_loss": rate0["loss"], "gnorm": first["gnorm"],
           "seeded_steps_equal": same, "step_ms": first["step_ms"],
           "rate0_step_ms": rate0["step_ms"], "peak_gib": first["peak_gib"],
           "rate0_peak_gib": rate0["peak_gib"],
           "launches": first["launches"],
           "main_batch_dense_logits_gib": dense_gib,
           "seconds": time.time() - t0}
    emit(row)
    check(first["attn_chunk"] == 0 and rate0["attn_chunk"] > 0,
          f"dropout chunk {first['attn_chunk']}, rate 0 {rate0['attn_chunk']}")
    check(math.isfinite(first["loss"]) and first["loss"] != rate0["loss"],
          f"dropout loss {first['loss']} vs rate 0 {rate0['loss']}")
    check(same, "two dropout steps from one seed differ")
    check(first["launches"] == (8 * n_lv, 4 * n_lv, 0),
          f"dropout step launches {first['launches']}")
    names = ("banded_conv", "banded_conv_dw", "banded_stem")
    return {name: sum(r["launches"][i] for r in (rate0, first, again))
            for i, name in enumerate(names)}


def phase_resume(torch, tmp):
    """``python -m agile3d_torch.main`` (in process) at full width on the
    training reference scenes: one epoch (``--epochs 1``, whose last epoch
    writes the rolling checkpoint), then ``--resume`` that checkpoint with
    ``--epochs 2``: it starts at epoch 1, restores the weights, BatchNorm
    statistics and optimizer state bit for bit and runs one more epoch;
    launches per step as the routing rule gives them."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import main as pmain
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.utils.ckpt import export_reference_state_dict

    t0 = time.time()
    scans, lst = write_benchmark(os.path.join(tmp, "resume"),
                                 **TRAIN_REF_SCENES)
    ds = InterMultiObjDataset(scans, lst, Config().model.voxel_size)
    n_lv = _banded_levels(collate_scenes([ds[i] for i in range(len(ds))],
                                         Config().buckets).pyramid)
    out_dir = os.path.join(tmp, "resume_out")
    ckpt_path = os.path.join(out_dir, "checkpoint.pth")

    def opt_state(opt):
        st = opt.state_dict()
        return st["count"], {n: {k: v.detach().cpu().clone()
                                 for k, v in d.items()}
                             for n, d in st["params"].items()}

    def same_state(a, b):
        return a[0] == b[0] and a[1].keys() == b[1].keys() and all(
            torch.equal(a[1][n][k], v) for n, d in b[1].items()
            for k, v in d.items())

    def same_model(sd, ref):
        return sd.keys() == ref.keys() and all(
            np.array_equal(sd[k], np.asarray(v)) for k, v in ref.items())

    def run(*extra):
        args = pmain.get_args_parser().parse_args([
            "--scan_folder", scans, "--train_list", lst, "--val_list", lst,
            "--val_epochs", "50", "--seed", "0", "--output_dir", out_dir,
            "--device", DEVICE, *extra])
        zero_launches()
        t = time.time()
        hist = pmain.main(args, log=lambda m: print(f"resume: {m}",
                                                    flush=True))
        torch.cuda.synchronize()
        return hist, kernel_launches(), time.time() - t

    first, launches1, wall1 = run("--epochs", "1")
    saved = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    saved_opt = (saved["optimizer"]["count"], saved["optimizer"]["params"])
    wrote_exact = (saved["epoch"] == 0
                   and same_model({k: v.numpy() for k, v in
                                   saved["model"].items()},
                                  export_reference_state_dict(first["model"]))
                   and same_state(opt_state(first["optimizer"]), saved_opt))

    restored = {}
    load = pmain.load_training_checkpoint

    def spy(path, model, optimizer):
        epoch = load(path, model, optimizer)
        # copies: on the CPU the exported arrays share the weights' memory
        restored.update(epoch=epoch, lr=optimizer.lr(optimizer.count),
                        model={k: v.copy() for k, v in
                               export_reference_state_dict(model).items()},
                        opt=opt_state(optimizer))
        return epoch

    pmain.load_training_checkpoint = spy
    try:
        second, launches2, wall2 = run("--epochs", "2", "--resume", ckpt_path)
    finally:
        pmain.load_training_checkpoint = load
    restored_exact = (restored["epoch"] == 0
                      and same_model({k: v.numpy() for k, v in
                                      saved["model"].items()},
                                     restored["model"])
                      and same_state(restored["opt"], saved_opt))
    after = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    steps = [len(range(0, len(ds), Config().train.batch_size))] * 2
    per_step = (12 * n_lv, 4 * n_lv, 0)
    got = [(lc["banded_conv"], lc["banded_conv_dw"], lc["banded_stem"])
           for lc in (launches1, launches2)]
    row = {"phase": "resume", "banded_levels": n_lv,
           "first": {"epochs_run": len(first["epochs"]),
                     "loss": first["epochs"][0]["loss"], "wall_s": wall1,
                     "launches": got[0]},
           "resumed": {"start_epoch": second["start_epoch"],
                       "epochs_run": len(second["epochs"]),
                       "loss": second["epochs"][0]["loss"], "wall_s": wall2,
                       "launches": got[1],
                       "count": second["optimizer"].count},
           "restored_lr": restored["lr"], "checkpoint_exact": wrote_exact,
           "restore_exact": restored_exact,
           "final_checkpoint_epoch": after["epoch"],
           "seconds": time.time() - t0}
    emit(row)
    check(wrote_exact, "checkpoint.pth does not hold the trained state")
    check(restored_exact, "--resume did not restore the saved state exactly")
    check(second["start_epoch"] == 1 and len(second["epochs"]) == 1,
          f"resumed at epoch {second['start_epoch']}, ran "
          f"{len(second['epochs'])}")
    check(second["optimizer"].count == 2 * steps[0] and after["epoch"] == 1,
          f"after the resumed epoch: count {second['optimizer'].count}, "
          f"checkpoint epoch {after['epoch']}")
    for i, lc in enumerate(got):
        want = tuple(c * steps[i] for c in per_step)
        check(lc == want, f"resume run {i}: launches {lc} != {want}")
    return {k: launches1[k] + launches2[k] for k in launches1}


def phase_train_main_path(torch, scans, train_list, tmp):
    """``agile3d_torch.main.main`` (in process) on synthetic ScanNet-sized
    scenes at full width: one epoch of TRAIN_STEPS steps at batch 5 and one
    validation, with the kernels' launches counted per step and the
    rollout, supervised step and backbone timed with CUDA events."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import main as pmain
    from agile3d_torch.engine import train as ptrain
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.row_gather import smem_row_gather
    from agile3d_torch.utils.ckpt import load_checkpoint

    with open(train_list) as f:
        scenes = list(json.load(f).items())
    val_list = os.path.join(tmp, "val_one.json")
    with open(val_list, "w") as f:
        json.dump(dict(scenes[:1]), f)
    train_list = os.path.join(tmp, "train_main.json")
    with open(train_list, "w") as f:
        json.dump(dict(scenes[:TRAIN_STEPS * TRAIN_BATCH]), f)
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
        seen.update(model=model, cfg=cfg)

        def step(device_batch, *args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner(device_batch, *args)
            end.record()
            end.synchronize()
            seen.update(batch=device_batch, args=args)
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
        with chunks_seen() as chunks:
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
    for _ in range(BACKWARD_PASSES):
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

    # one training step of the last batch from the trained weights (the
    # rollout's backbone in training mode without gradients, then the
    # supervised step): with the bf16 backbone, in f32 beside it, and in
    # f32 with --dropout 0.1 (dense attention at this batch)
    clicks, labels, num_obj = seen["args"][:3]
    bf16_steps = {}
    for key, dtype, rate in (("bfloat16", "bfloat16", 0.0),
                             ("float32", "float32", 0.0),
                             ("dropout", "float32", 0.1)):
        mcfg = dataclasses.replace(model.cfg, backbone_dtype=dtype,
                                   dropout=rate)
        twin = Agile3D(mcfg)
        twin.load_state_dict(model.state_dict())
        twin = twin.to(DEVICE)
        scfg = dataclasses.replace(seen["cfg"], model=mcfg)
        twin_opt, _ = ptrain.make_optimizer(twin, scfg, 1)
        twin_step = orig_make(scfg, twin, twin_opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with torch.no_grad():
            twin.forward_backbone(*seen["batch"], {})
        out = twin_step(seen["batch"], clicks, labels, num_obj,
                        torch.Generator(device=DEVICE).manual_seed(7)
                        if rate else None)
        end.record()
        end.synchronize()
        lc = kernel_launches()
        bf16_steps[key] = dict(
            attn_chunk=out["attn_chunk"],
            loss=float(out["loss"]), gnorm=float(out["gnorm"]),
            ms=start.elapsed_time(end),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=(lc["banded_conv"], lc["banded_conv_dw"],
                      lc["banded_stem"]),
            grads=torch.cat([p.grad.detach().flatten()
                             for p in twin.parameters()]).cpu())
        del twin, twin_opt, twin_step, out
        torch.cuda.empty_cache()
    bf16_cos = _cosine(bf16_steps["bfloat16"].pop("grads"),
                       bf16_steps["float32"].pop("grads"))
    bf16_steps["dropout"].pop("grads")

    row = {"phase": "train_main_path", "steps": len(steps),
           "rows": [st["rows"] for st in steps],
           "clicks": [st["clicks"] for st in steps],
           "launches": {"banded_conv": launches[0],
                        "banded_conv_dw": launches[1],
                        "banded_stem": launches[2], **probe_launches},
           "launches_per_step": per_step, "launches_val": val_launches,
           "attn_chunks": chunks,
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
           "val": {k: finite(v) for k, v in hist["val"].get(0, {}).items()},
           "val_losses": {k: finite(v) for k, v in
                          hist["val_losses"].get(0, {}).items()},
           "bf16_step": bf16_steps, "bf16_step_grad_cos_vs_f32": bf16_cos}
    emit(row)
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} steps != {TRAIN_STEPS}")
    # 98,304-row samples at batch 5: 16,384, 6 chunks (rollout, step, val)
    check(set(chunks) == {16384}, f"training attention chunks {chunks}")
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
    val_losses = hist["val_losses"].get(0, {})
    check(set(val_losses) == {"loss", "loss_bce", "loss_dice"}
          and all(math.isfinite(v) for v in val_losses.values()),
          f"validation losses {val_losses}")
    b16 = bf16_steps["bfloat16"]
    check(b16["launches"] == (24, 8, 0),
          f"bf16 training step launches {b16['launches']} != (24, 8, 0)")
    check(math.isfinite(b16["loss"]) and math.isfinite(b16["gnorm"]),
          "bf16 training step: non-finite loss or gnorm")
    # as the bf16 phase's limit against the CPU's f32 step
    check(bf16_cos >= 0.5, f"bf16 training step vs f32 on the card: "
                           f"gradient cosine {bf16_cos}")
    drop = bf16_steps["dropout"]
    check(drop["attn_chunk"] == 0 and math.isfinite(drop["loss"])
          and drop["launches"] == (24, 8, 0),
          f"dropout step of the training batch: {drop}")
    return {"banded_conv": launches[0], "banded_conv_dw": launches[1],
            "banded_stem": launches[2], **probe_launches}


def phase_train_device_rollout(torch, scans, train_list, tmp):
    """``agile3d_torch.main.main --device_rollout`` (in process) for one
    step of TRAIN_BATCH scenes, its rollout held at DEVICE_ITERS + 1 rounds,
    with the launches counted and the rollout and the step timed with CUDA
    events; then that batch through the device and the host rollouts with
    the click order pinned (increasing draws; the host's identity shuffle):
    the click sets must agree."""
    from agile3d_torch import main as pmain
    from agile3d_torch.engine import device_train
    from agile3d_torch.engine import train as ptrain
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.boundary_dist import boundary_distances_all
    from agile3d_torch.ops.row_gather import smem_row_gather

    with open(train_list) as f:
        first = dict(list(json.load(f).items())[:TRAIN_BATCH])
    one_batch = os.path.join(tmp, "train_one_batch.json")
    with open(one_batch, "w") as f:
        json.dump(first, f)
    out_dir = os.path.join(tmp, "train_device_out")

    def counts():
        return (banded_conv.launches, banded_conv_dw.launches,
                banded_stem_conv.launches, boundary_distances_all.launches)

    seen = {}
    orig_rollout, orig_make = ptrain.train_rollout, pmain.make_train_step

    def rollout(model, scene, labels, num_obj, num_iters, gen, mc, max_label):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = counts()
        t = time.time()
        start.record()
        # the table for DEVICE_ITERS + 1 rounds, not for the drawn count
        mc = next(b for b in InteractiveEngine.CLICK_BUCKETS
                  if b >= (DEVICE_ITERS + 1) * max_label)
        cs, n_clicks = orig_rollout(model, scene, labels, num_obj,
                                    DEVICE_ITERS, gen, mc, max_label)
        end.record()
        end.synchronize()
        seen.update(scene=scene, labels=labels, num_obj=num_obj, mc=mc,
                    max_label=max_label, drawn_iters=num_iters,
                    rollout=(start, end), rollout_wall_s=time.time() - t,
                    rollout_launches=tuple(a - b for a, b in
                                           zip(counts(), before)),
                    clicks=cs, counts=n_clicks)
        return cs, n_clicks

    def make_train_step(cfg, model, optimizer):
        inner = orig_make(cfg, model, optimizer)
        seen.update(model=model, cfg=cfg)

        def step(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner(*args)
            end.record()
            end.synchronize()
            seen.update(step=(start, end), at_step=counts(),
                        loss=float(out["loss"]), gnorm=float(out["gnorm"]),
                        step_clicks=args[1].vox.shape[1])
            return out
        return step

    args = pmain.get_args_parser().parse_args([
        "--scan_folder", scans, "--train_list", one_batch,
        "--val_list", one_batch, "--epochs", "1", "--val_epochs", "2",
        "--batch_size", str(TRAIN_BATCH), "--seed", "0",
        "--output_dir", out_dir, "--device", DEVICE, "--device_rollout"])
    ptrain.train_rollout, pmain.make_train_step = rollout, make_train_step
    t0 = time.time()
    try:
        banded_conv.launches = banded_conv_dw.launches = 0
        banded_stem_conv.launches = boundary_distances_all.launches = 0
        banded_window_conv.launches = smem_row_gather.launches = 0
        with chunks_seen() as chunks:
            pmain.main(args, log=lambda msg: print(f"main: {msg}",
                                                   flush=True))
        torch.cuda.synchronize()
        launches = counts()
        probe_launches = {"banded_window_conv": banded_window_conv.launches,
                          "smem_row_gather": smem_row_gather.launches}
    finally:
        ptrain.train_rollout, pmain.make_train_step = orig_rollout, orig_make
    wall_s = time.time() - t0
    check("at_step" in seen, "no supervised step after the device rollout")
    labels, num_obj = seen["labels"], seen["num_obj"]
    n_clicks = seen["counts"].cpu().numpy()
    vox = seen["clicks"].vox.cpu().numpy()
    obj = seen["clicks"].obj.cpu().numpy()
    lab = labels.cpu().numpy()
    on_object = all((lab[i][vox[i, :c]] == obj[i, :c]).all()
                    for i, c in enumerate(n_clicks))

    # the same batch, scene and weights through both rollouts, order pinned
    model, cfg, scene = seen["model"], seen["cfg"], seen["scene"]
    engine = InteractiveEngine(cfg, model, DEVICE)
    b = lab.shape[0]
    n_valid = [int((lab[i] >= 0).sum()) for i in range(b)]
    raw = [scene.raw[i, :n_valid[i]].cpu().numpy() for i in range(b)]
    num_obj_np = num_obj.cpu().numpy()

    class PinnedRng(random.Random):
        def randint(self, a, b):
            return DEVICE_ITERS

        def shuffle(self, x):
            pass

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.time()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), time.time() - t

    host, host_ms, host_wall = timed(lambda: ptrain.rollout_clicks(
        engine, scene, lab, num_obj_np, raw, n_valid, PinnedRng(0), cfg))
    s_cap = seen["max_label"]
    pinned = torch.arange(s_cap, dtype=torch.float32,
                          device=DEVICE).expand(b, s_cap)
    (cs, dev_counts), dev_ms, dev_wall = timed(
        lambda: device_train.train_rollout(
            model, scene, labels, num_obj, DEVICE_ITERS, None, seen["mc"],
            s_cap, order=pinned))
    dev_counts = dev_counts.cpu().numpy()
    dvox, dobj = cs.vox.cpu().numpy(), cs.obj.cpu().numpy()
    sets_equal = all(
        int(dev_counts[i]) == host[i].count
        and sorted(zip(dvox[i, :dev_counts[i]].tolist(),
                       dobj[i, :dev_counts[i]].tolist()))
        == sorted(zip(host[i].vox[:host[i].count].tolist(),
                      host[i].obj[:host[i].count].tolist()))
        for i in range(b))
    pinned_on_object = all((lab[i][dvox[i, :c]] == dobj[i, :c]).all()
                           for i, c in enumerate(dev_counts))

    step_launches = seen["at_step"]
    row = {"phase": "train_device_rollout", "rounds": DEVICE_ITERS + 1,
           "drawn_iters": seen["drawn_iters"], "clicks": n_clicks.tolist(),
           "step_clicks": seen["step_clicks"],
           "launches": {"banded_conv": step_launches[0],
                        "banded_conv_dw": step_launches[1],
                        "banded_stem": step_launches[2],
                        "boundary_distances_all": step_launches[3],
                        **probe_launches},
           "rollout_launches": seen["rollout_launches"],
           "rollout_ms": seen["rollout"][0].elapsed_time(seen["rollout"][1]),
           "rollout_wall_s": seen["rollout_wall_s"],
           "step_ms": seen["step"][0].elapsed_time(seen["step"][1]),
           "loss": seen["loss"], "gnorm": seen["gnorm"], "wall_s": wall_s,
           "attn_chunks": chunks,
           "pinned": {"counts": dev_counts.tolist(), "sets_equal": sets_equal,
                      "device_rollout_ms": dev_ms,
                      "device_rollout_wall_s": dev_wall,
                      "host_rollout_ms": host_ms,
                      "host_rollout_wall_s": host_wall}}
    emit(row)
    check(set(chunks) == {16384}, f"training attention chunks {chunks}")
    check(step_launches == (24, 8, 0, DEVICE_ITERS + 1),
          f"launches of the device-rollout step {step_launches} != "
          f"(24, 8, 0, {DEVICE_ITERS + 1})")
    check(seen["rollout_launches"] == (0, 0, 0, DEVICE_ITERS + 1),
          f"rollout launches {seen['rollout_launches']}")
    check(all(v == 0 for v in probe_launches.values()),
          f"a probe kernel ran on the training path: {probe_launches}")
    check(n_clicks.min() > 0 and on_object,
          "device rollout: a sample without clicks or a click off its object")
    check(sets_equal and pinned_on_object,
          "device and host rollouts picked other click sets")
    check(math.isfinite(seen["loss"]) and math.isfinite(seen["gnorm"]),
          "non-finite loss or gnorm after the device rollout")
    return dict(zip(("banded_conv", "banded_conv_dw", "banded_stem",
                     "boundary_distances_all"), step_launches),
                **probe_launches)


def _model_inputs(torch, batch):
    """(pyramid, feats, raw, sample_idx) of a collated batch on the card."""
    from agile3d_torch.sparse.grid import to_device

    return (to_device(batch.pyramid, DEVICE),
            *(torch.from_numpy(a).to(DEVICE)
              for a in (batch.feats, batch.raw, batch.sample_idx)))


def _rel(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want| + 1)."""
    return (float((got - want).abs().max()), float(want.abs().max()) + 1.0)


def phase_variants(torch, batch, scans, val_list, tmp):
    """The Res16UNet variants at full width on the smoke scene, seeded
    random weights: VARIANT_MODEL (BasicBlock) through the whole model, one
    ``forward_backbone`` and one ``forward_mask`` with the kernels on, then
    off (plain f32 on the card), then ``evaluate_dataset`` through the
    device rollout; VARIANT_BACKBONE (Bottleneck) as ``Res16UNet`` alone,
    kernels on and off, and ``Agile3D`` refusing it. B1 launches per
    forward must be what the routing rule predicts
    (``models/backbone.py::banded_convs``)."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch.config import Config, ModelConfig
    from agile3d_torch.data.datasets import InterMultiObjDataset
    from agile3d_torch.engine.eval import InteractiveEngine, evaluate_dataset
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
    from agile3d_torch.models.backbone import (
        backbone_config,
        banded_convs,
        init_res16unet,
    )

    t0 = time.time()
    n_valid = int((batch.sample_idx[0] >= 0).sum())
    num_obj = int(batch.num_obj[0])
    clicks = type(_clicks(torch, batch.labels[0, :n_valid], num_obj))(
        *(t.to(DEVICE) for t in _clicks(torch, batch.labels[0, :n_valid],
                                         num_obj)))
    no = torch.tensor([num_obj], dtype=torch.int32, device=DEVICE)
    inputs = _model_inputs(torch, batch)
    pyr, feats = inputs[0], inputs[1]
    valid0 = [lv.num_valid for lv in batch.pyramid.levels][::-1]

    def fpn_err(got, want):
        errs = [_rel(g[:n], w[:n]) for g, w, n in zip(got, want, valid0)]
        return max(e for e, _ in errs), max(m for _, m in errs)

    out = {}
    # the whole model: a BasicBlock variant
    mcfg = ModelConfig(backbone=backbone_config(VARIANT_MODEL))
    model = init_agile3d(mcfg, seed=0, device=DEVICE)
    bb_cfg = model.backbone.cfg
    with torch.no_grad():
        zero_launches()
        scene = model.forward_backbone(*inputs)
        masks = model.forward_mask(scene, clicks, no)["pred_masks"][
            0, :n_valid, :num_obj + 1]
        torch.cuda.synchronize()
        launches = kernel_launches()
        fpn = model.backbone(pyr, feats)
        model.backbone.cfg = dataclasses.replace(bb_cfg, banded_conv=False)
        zero_launches()
        fpn_plain = model.backbone(pyr, feats)
        masks_plain = model.forward_mask(model.forward_backbone(*inputs),
                                         clicks, no)["pred_masks"][
            0, :n_valid, :num_obj + 1]
        torch.cuda.synchronize()
        plain_launches = kernel_launches()
        model.backbone.cfg = bb_cfg
    mask_err, mask_scale = _rel(masks, masks_plain)
    agree = float((masks.argmax(-1) == masks_plain.argmax(-1)).float().mean())
    err, scale = fpn_err(fpn, fpn_plain)
    out[VARIANT_MODEL] = dict(
        predicted_k3=banded_convs(bb_cfg), launches=launches,
        plain_launches=plain_launches, fpn_max_abs_err=err, fpn_scale=scale,
        mask_max_abs_err=mask_err, mask_scale=mask_scale,
        label_agree=agree,
        channels=[int(f.shape[1]) for f in fpn])
    del fpn, fpn_plain, masks, masks_plain, scene

    # evaluate_dataset through the device rollout, kernels on
    cfg = Config(model=mcfg)
    engine = InteractiveEngine(cfg, model, DEVICE)
    csv = os.path.join(tmp, "variant_results.csv")
    zero_launches()
    evaluate_dataset(engine, InterMultiObjDataset(scans, val_list,
                                                  mcfg.voxel_size),
                     csv, max_num_clicks=VARIANT_CLICKS, seed=0,
                     log=lambda m: None)
    torch.cuda.synchronize()
    eval_launches = kernel_launches()
    rows = [r.split(" ") for r in open(csv).read().strip().split("\n") if r]
    ious = [float(r[4]) for r in rows]
    out[VARIANT_MODEL].update(eval_rows=len(rows), eval_final_iou=ious[-1],
                              eval_launches=eval_launches)
    del engine, model
    torch.cuda.empty_cache()

    # the backbone alone: a Bottleneck variant
    bcfg = backbone_config(VARIANT_BACKBONE)
    net = init_res16unet(bcfg, seed=0, device=DEVICE)
    with torch.no_grad():
        zero_launches()
        fpn = net(pyr, feats)
        torch.cuda.synchronize()
        launches = kernel_launches()
        net.cfg = dataclasses.replace(bcfg, banded_conv=False)
        fpn_plain = net(pyr, feats)
    err, scale = fpn_err(fpn, fpn_plain)
    try:
        Agile3D(ModelConfig(backbone=bcfg))
        refused = ""
    except ValueError as e:
        refused = str(e)
    out[VARIANT_BACKBONE] = dict(
        predicted_k3=banded_convs(bcfg), launches=launches,
        fpn_max_abs_err=err, fpn_scale=scale,
        channels=[int(f.shape[1]) for f in fpn], model_refused=refused)
    del fpn, fpn_plain, net
    torch.cuda.empty_cache()
    emit({"phase": "variants", "rows": batch.pyramid.levels[0].grid.shape[0],
          "num_valid": n_valid, **out, "seconds": time.time() - t0})

    m, b = out[VARIANT_MODEL], out[VARIANT_BACKBONE]
    for name, r in out.items():
        check(r["launches"]["banded_conv"] == r["predicted_k3"],
              f"{name}: {r['launches']['banded_conv']} k3 launches, the "
              f"routing rule predicts {r['predicted_k3']}")
        check(r["launches"]["banded_stem"] == 1,
              f"{name}: {r['launches']['banded_stem']} stem launches")
        check(r["fpn_max_abs_err"] <= 5e-2 * r["fpn_scale"],
              f"{name}: FPN kernels vs plain {r['fpn_max_abs_err']} > 5e-2 x "
              f"{r['fpn_scale']}")
    check(m["plain_launches"]["banded_conv"] == 0
          and m["plain_launches"]["banded_stem"] == 0,
          f"{VARIANT_MODEL}: a kernel ran with the kernels off")
    check(m["mask_max_abs_err"] <= 5e-2 * m["mask_scale"],
          f"{VARIANT_MODEL}: masks kernels vs plain {m['mask_max_abs_err']}")
    check(m["label_agree"] >= 0.99,
          f"{VARIANT_MODEL}: labels agree {m['label_agree']}")
    check(m["eval_rows"] > 1 and all(math.isfinite(v) and 0 <= v <= 1
                                     for v in ious),
          f"{VARIANT_MODEL}: eval rows {m['eval_rows']}, IoUs {ious[:5]}")
    check(m["eval_launches"]["banded_conv"] == m["predicted_k3"]
          and m["eval_launches"]["boundary_distances_all"] > 0,
          f"{VARIANT_MODEL}: eval launches {m['eval_launches']}")
    check("lin_squeeze" in b["model_refused"],
          f"Agile3D did not refuse {VARIANT_BACKBONE}: {b['model_refused']}")
    return {"banded_conv": m["launches"]["banded_conv"]
            + m["eval_launches"]["banded_conv"] + b["launches"]["banded_conv"],
            "banded_stem": m["launches"]["banded_stem"]
            + m["eval_launches"]["banded_stem"] + b["launches"]["banded_stem"],
            "boundary_distances_all":
                m["eval_launches"]["boundary_distances_all"]}


def phase_oversize(torch, scans, val_list, tmp):
    """``python -m agile3d_torch.eval_multi_obj`` (in process) with the
    memory budget pinned at 0.01 GiB (``AGILE3D_HBM_GIB``): it must exit
    non-zero with one ``error:`` line, before any kernel launch."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.cli import run

    argv = ["--scan_folder", scans, "--val_list", val_list, "--seed", "0",
            "--output_dir", os.path.join(tmp, "oversize"), "--device",
            DEVICE] + REFERENCE_BLOCK
    err = io.StringIO()
    os.environ["AGILE3D_HBM_GIB"] = "0.01"
    code = None
    try:
        zero_launches()
        with contextlib.redirect_stderr(err):
            run(eval_multi_obj.get_args_parser(), eval_multi_obj.main, argv)
    except SystemExit as e:
        code = e.code
    finally:
        del os.environ["AGILE3D_HBM_GIB"]
    torch.cuda.synchronize()
    launches = kernel_launches()
    lines = err.getvalue().strip().splitlines()
    emit({"phase": "oversize", "exit_code": code, "stderr": lines,
          "launches": launches})
    check(code not in (None, 0), f"the over-budget run exited {code}")
    check(len(lines) == 1 and lines[0].startswith("error: scene pads to"),
          f"the over-budget run's stderr: {lines}")
    check(not any(launches.values()),
          f"kernels launched before the guard: {launches}")
    return launches


def phase_memory(torch, batch, tmp):
    """The eval footprint: the peak device memory of one eval
    ``forward_backbone`` and one ``forward_mask`` at full width, less what
    the process held before the model was built (earlier phases' leftovers),
    so the model's weights, the inputs and the passes' tensors; at the smoke
    scene's bucket and at a scene that pads to the 786,432-row bucket,
    against the oversize guard's estimate (``utils/costs.py::
    eval_hbm_gib``)."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.utils.costs import (
        EVAL_BYTES_PER_ROW,
        SINGLE_CHIP_HBM_GIB,
        eval_hbm_gib,
    )

    t0 = time.time()
    cfg = Config()
    scans, val_list = write_benchmark(os.path.join(tmp, "memory"),
                                      **MEMORY_SCENE)
    prep = time.time()
    big = collate_scenes(
        [InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)[0]],
        cfg.buckets)
    prep_s = time.time() - prep
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = init_agile3d(cfg.model, seed=0, device=DEVICE)
    weights = torch.cuda.memory_allocated() - before
    rows = {}
    for name, b in (("smoke", batch), ("kitti", big)):
        n_valid = int((b.sample_idx[0] >= 0).sum())
        num_obj = int(b.num_obj[0])
        clicks = type(_clicks(torch, b.labels[0, :n_valid], num_obj))(
            *(t.to(DEVICE) for t in _clicks(torch, b.labels[0, :n_valid],
                                             num_obj)))
        no = torch.tensor([num_obj], dtype=torch.int32, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            inputs = _model_inputs(torch, b)
            scene = model.forward_backbone(*inputs)
            out = model.forward_mask(scene, clicks, no)
            finite_ok = bool(torch.isfinite(
                out["pred_masks"][0, :n_valid, :num_obj + 1]).all())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n = b.pyramid.levels[0].grid.shape[0]
        rows[name] = dict(rows=n, num_valid=n_valid,
                          process_peak_gib=peak / 2 ** 30,
                          footprint_gib=(peak - before) / 2 ** 30,
                          above_weights_gib=(peak - base) / 2 ** 30,
                          footprint_bytes_per_row=(peak - before) / n,
                          estimate_gib=eval_hbm_gib(n), finite=finite_ok)
        del inputs, scene, out
    del model
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "memory", "card": nvidia_smi(),
          "total_memory_gib": total / 2 ** 30,
          "single_chip_hbm_gib": SINGLE_CHIP_HBM_GIB,
          "eval_bytes_per_row": EVAL_BYTES_PER_ROW,
          "held_before_gib": before / 2 ** 30, "weights_gib": weights / 2 ** 30,
          **rows,
          "prep_s": prep_s, "seconds": time.time() - t0})
    check(rows["kitti"]["rows"] == 786432,
          f"the memory scene pads to {rows['kitti']['rows']} rows")
    for name, r in rows.items():
        check(r["finite"], f"memory ({name}): non-finite masks")
        check(r["estimate_gib"] >= r["footprint_gib"],
              f"memory ({name}): the guard's estimate {r['estimate_gib']} "
              f"GiB is under the measured footprint {r['footprint_gib']} GiB")
    check(SINGLE_CHIP_HBM_GIB <= total / 2 ** 30,
          f"SINGLE_CHIP_HBM_GIB {SINGLE_CHIP_HBM_GIB} > the card's "
          f"{total / 2 ** 30} GiB")


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def phase_benches(torch):
    """``python -m agile3d_torch.bench`` and ``... bench_train`` (in
    process): each prints one JSON line, whose numbers must be finite, and
    whose runs launch the kernels as the paths predict: 8 k3 + 1 stem per
    eval backbone forward; 16 k3 (8 forward, 8 dX) + 8 dW per supervised
    step (the training epoch's 24 k3 add the rollout's no-gradient
    backbone, which the bench's fixed click table skips)."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import bench, bench_train

    t0 = time.time()
    lines, launches = {}, {}
    for name, mod, argv in (("bench", bench, BENCH_ARGS),
                            ("bench_train", bench_train, BENCH_TRAIN_ARGS)):
        buf = io.StringIO()
        zero_launches()
        with contextlib.redirect_stdout(buf):
            mod.main(mod.get_args_parser().parse_args(argv))
        torch.cuda.synchronize()
        launches[name] = kernel_launches()
        lines[name] = _last_json(buf.getvalue())
        print(buf.getvalue(), end="", flush=True)
    b, t = lines["bench"], lines["bench_train"]
    calls = b["raw"]["backbone"]["calls"]
    steps = t["breakdown"]["steps"]
    host = {k: t["breakdown"][k] for k in (
        "host_path", "host_batch_assembly_ms", "epoch_step_serial_ms",
        "epoch_step_prefetch_ms", "numpy_host")}
    emit({"phase": "benches", "launches": launches,
          "bench_value_ms": b["value"], "bench_train_value": t["value"],
          "bench_train_host": host, "seconds": time.time() - t0})
    check(host["host_path"] == "native" and host["numpy_host"] is not None,
          f"bench_train: host prep {host}")

    def all_finite(obj):
        if isinstance(obj, dict):
            return all(all_finite(v) for v in obj.values())
        if isinstance(obj, list):
            return all(all_finite(v) for v in obj)
        return not isinstance(obj, float) or math.isfinite(obj)

    for name, line in lines.items():
        check(all_finite(line), f"{name}: a number is not finite")
    check(b["metric"] == "per_click_forward_mask_p50_latency"
          and b["value"] > 0 and "mfu" in b["roofline"]["forward_mask"],
          f"bench line: {b}")
    check(b["raw"]["backbone"]["launches"] == {"banded_conv": 8,
                                               "banded_stem": 1},
          f"bench: launches per backbone {b['raw']['backbone']['launches']}")
    check(launches["bench"]["banded_conv"] == 8 * calls
          and launches["bench"]["banded_stem"] == calls,
          f"bench: {launches['bench']} over {calls} backbone forwards")
    check(t["metric"] == "train_scenes_per_sec_per_chip" and t["value"] > 0
          and "mfu" in t["roofline"], f"bench_train line: {t}")
    check(t["breakdown"]["launches_per_step"] == {"banded_conv": 16,
                                                  "banded_conv_dw": 8},
          f"bench_train: launches per step "
          f"{t['breakdown']['launches_per_step']}")
    check(launches["bench_train"]["banded_conv"] == 16 * steps
          and launches["bench_train"]["banded_conv_dw"] == 8 * steps,
          f"bench_train: {launches['bench_train']} over {steps} steps")
    return launches, lines



# ---------------------------------------------------------------------------
# The parallel paths: two gloo ranks on the one card
# ---------------------------------------------------------------------------

# two ranks share the one card: what they measure is function and memory,
# not scaling
PARALLEL_RANKS = 2
# the SP rollouts at 2 clicks an object (cut from the main path's 5, to
# hold the time; it ran 3): 8 rounds after round 0
SP_CLICKS = 2
# JAX's band for the sharded decoder against the one-process one
# (tests/test_parallel.py), rtol and atol
SP_BAND = 2e-3
# data parallelism: 4 scenes of the training reference's kind, 2 a rank,
# so that each replica's batch pads to the 65,536-row level 0 (not the
# 524,288-row batch: two replicas of ~37 GiB would not fit on one card
# beside gloo's host staging); one step
DP_SCENES = dict(TRAIN_REF_SCENES, num_scenes=4)
DP_BATCH = 2
# the one-process step against the dp step on two identical groups:
# tests/test_dp_train.py's bounds
DP_LOSS_TOL = 1e-5
DP_PARAM_TOL = dict(atol=5e-6, rtol=1e-4)


def _eval_argv(scans, val_list, out_dir, *extra):
    return (["--scan_folder", scans, "--val_list", val_list, "--seed", "0",
             "--max_num_clicks", str(SP_CLICKS), "--output_dir", out_dir,
             "--device", DEVICE] + REFERENCE_BLOCK + list(extra))


def _csv_rows(out_dir):
    with open(os.path.join(out_dir, "val_results_multi.csv")) as f:
        return [r.split(" ") for r in f.read().strip().split("\n") if r]


def _sp_decoder_rank(torch, mesh, scans, val_list):
    """The sharded decoder against the one-process ``forward_mask`` on this
    rank's rows of the smoke scene: the largest difference in units of the
    band, and the labels equal where the one-process top two logits differ
    by more than the band; the one-process pass timed alone on the card,
    the sharded pass on both ranks at once."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.parallel.mesh import barrier, psum
    from agile3d_torch.parallel.sp import make_forward_mask_sp
    from agile3d_torch.sparse.grid import to_device

    cfg = Config()
    model = init_agile3d(cfg.model, seed=0, device=DEVICE)
    batch = collate_scenes([InterMultiObjDataset(
        scans, val_list, cfg.model.voxel_size)[0]], cfg.buckets)
    dev = mesh.device
    with torch.no_grad():
        scene = model.forward_backbone(
            to_device(batch.pyramid, dev),
            *(torch.from_numpy(a).to(dev)
              for a in (batch.feats, batch.raw, batch.sample_idx)))
    n_valid = int((batch.sample_idx[0] >= 0).sum())
    num_obj = int(batch.num_obj[0])
    host_clicks = _clicks(torch, batch.labels[0, :n_valid], num_obj)
    clicks = type(host_clicks)(*(t.to(dev) for t in host_clicks))
    no = torch.tensor([num_obj], dtype=torch.int32, device=dev)
    axis = mesh["sp"]
    fm_sp, shard = make_forward_mask_sp(mesh, cfg.model)
    scene_l = shard(scene)
    one = lambda: model.forward_mask(scene, clicks, no)
    sharded = lambda: fm_sp(model, scene_l, clicks, no)
    with torch.no_grad():
        ref = one()
        got = sharded()
        one_ms = one_wall = None
        barrier(axis)
        if axis.index == 0:   # alone on the card
            one_ms = time_ms(torch, one, reps=5)
            one_wall = wall_ms(torch, one, reps=5)
        barrier(axis)
        sp_ms = time_ms(torch, sharded, reps=5)
        sp_wall = wall_ms(torch, sharded, reps=5)
    nl = scene_l.mask_feat.shape[1]
    lo = axis.index * nl
    cols = slice(0, num_obj + 1)
    valid = scene_l.vox_valid[0]
    want = ref["all_masks"][:, 0, lo:lo + nl, cols][:, valid]
    have = got["all_masks"][:, 0, :, cols][:, valid]
    diff = (have - want).abs()
    excess = float((diff / (SP_BAND + SP_BAND * want.abs())).max())
    top2 = want[-1].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > SP_BAND + SP_BAND * top2[:, 0].abs()
    equal = have[-1].argmax(-1) == want[-1].argmax(-1)
    counts = psum(torch.tensor([float(equal.sum()), float(equal.numel()),
                                float((equal | ~clear).sum()),
                                float(clear.numel())], device=dev), axis)
    return dict(rows_per_rank=nl, chunk=ref["attn_chunk"],
                max_abs_diff=float(diff.max()), band_ratio=excess,
                labels_equal_share=float(counts[0] / counts[1]),
                labels_equal_where_clear=int(counts[2]) == int(counts[3]),
                one_process_ms=one_ms, one_process_wall_ms=one_wall,
                sp_ms=sp_ms, sp_wall_ms=sp_wall)


def _sp_eval_rank(torch, scans, val_list, out_dir, sp_backbone: bool):
    """``python -m agile3d_torch.eval_multi_obj --sp 2 [--sp_backbone]``
    (``main(args)``, in this rank of the group), launches counted around it;
    under ``--sp_backbone`` each halo exchange's rows and width recorded."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.parallel import sp_backbone as psb

    halo = {}
    orig = psb._halo_exchange

    def exchange(x_local, halo_src, axis):
        key = (x_local.shape[0], halo_src.shape[0], x_local.shape[1])
        halo[key] = halo.get(key, 0) + 1
        return orig(x_local, halo_src, axis)

    extra = ["--sp", str(PARALLEL_RANKS)] + (["--sp_backbone"]
                                             if sp_backbone else [])
    args = eval_multi_obj.get_args_parser().parse_args(
        _eval_argv(scans, val_list, out_dir, *extra))
    psb._halo_exchange = exchange
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        zero_launches()
        results = eval_multi_obj.main(args, log=lambda m: None)
        torch.cuda.synchronize()
        launches = kernel_launches()
    finally:
        psb._halo_exchange = orig
    return dict(launches=launches, wall_s=time.time() - t0, results=results,
                halo=[dict(rows=r, halo_rows=h, channels=c, calls=n,
                           bytes_per_rank=4 * h * c)
                      for (r, h, c), n in sorted(halo.items())])


def _dp_rank(torch, dp_scans, dp_list, out_dir):
    """Data parallelism in this rank: one step on two identical groups
    against the one-process step on that group; then ``python -m
    agile3d_torch.main --num_dp 2`` for one epoch (``main(args)``), its
    rollout's and step's launches counted, against the one-process
    ``--device_rollout`` rollout and step on this rank's batch."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import main as pmain
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset
    from agile3d_torch.engine.device_train import train_rollout
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.engine.train import (
        device_click_state,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from agile3d_torch.models.agile3d import init_agile3d
    from agile3d_torch.parallel import train as ptrain
    from agile3d_torch.parallel.mesh import make_mesh, pmax
    from agile3d_torch.sparse.grid import to_device

    cfg = Config()
    dev = torch.device(DEVICE, torch.cuda.current_device())
    ds = InterMultiObjDataset(dp_scans, dp_list, cfg.model.voxel_size)
    batch, labels, num_obj, _ = prepare_batch(ds, [0, 1], cfg, 0)
    host_clicks = _train_clicks(torch, labels, num_obj)
    clicks = type(host_clicks)(*(t.to(dev) for t in host_clicks))
    inputs = ((to_device(batch.pyramid, dev),
               *(torch.from_numpy(a).to(dev)
                 for a in (batch.feats, batch.raw, batch.sample_idx))),
              clicks, torch.from_numpy(labels).to(dev),
              torch.from_numpy(num_obj).to(dev))
    model0 = init_agile3d(cfg.model, seed=0, device="cpu")
    mesh = make_mesh(n_dp=PARALLEL_RANKS, n_sp=1, device=dev)

    def step_on(make):
        model = copy.deepcopy(model0).to(dev)
        opt, _ = make_optimizer(model, cfg, 1)
        out = make(model, opt)(*inputs)
        return out, {k: v.detach() for k, v in model.state_dict().items()}

    one, one_state = step_on(lambda m, o: make_train_step(cfg, m, o))
    zero_launches()
    dp, dp_state = step_on(lambda m, o: lambda *a: ptrain.make_dp_train_step(
        cfg, m, o, mesh)(*a, np.ones(PARALLEL_RANKS, np.float32)))
    step_launches = kernel_launches()
    worst = max(float(((dp_state[k].float() - v.float()).abs()
                       - DP_PARAM_TOL["rtol"] * v.float().abs()).max())
                for k, v in one_state.items() if v.is_floating_point())
    identical = dict(
        loss_diff=abs(float(dp["loss"]) - float(one["loss"])),
        miou_diff=abs(float(dp["miou"]) - float(one["miou"])),
        gnorm=(float(dp["gnorm"]), float(one["gnorm"])),
        param_excess=worst, launches=step_launches)
    del one_state, dp_state

    # the entry point: the rollout's and the step's launches on this rank
    seen = {"steps": []}
    orig_rollout, orig_step = ptrain.make_dp_rollout, pmain.make_dp_train_step

    def make_dp_rollout(cfg_, mesh_):
        inner = orig_rollout(cfg_, mesh_)

        def rollout(engine, batch_, labels_, num_obj_, num_iters, seed):
            before = kernel_launches()
            out = inner(engine, batch_, labels_, num_obj_, num_iters, seed)
            seen.update(engine=engine, batch=batch_, labels=labels_,
                        num_obj=num_obj_, num_iters=num_iters,
                        rollout_launches={k: v - before[k] for k, v in
                                          kernel_launches().items()})
            return out
        return rollout

    def make_dp_train_step(cfg_, model, opt, mesh_):
        inner = orig_step(cfg_, model, opt, mesh_)

        def step(*args):
            before = kernel_launches()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner(*args)
            end.record()
            end.synchronize()
            seen["steps"].append(dict(
                ms=start.elapsed_time(end), loss=float(out["loss"]),
                launches={k: v - before[k] for k, v in
                          kernel_launches().items()}))
            return out
        return step

    args = pmain.get_args_parser().parse_args([
        "--scan_folder", dp_scans, "--train_list", dp_list, "--val_list",
        dp_list, "--epochs", "1", "--val_epochs", "2", "--batch_size",
        str(DP_BATCH), "--seed", "0", "--output_dir", out_dir, "--device",
        DEVICE, "--num_dp", str(PARALLEL_RANKS)])
    ptrain.make_dp_rollout = make_dp_rollout
    pmain.make_dp_train_step = make_dp_train_step
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        zero_launches()
        history = pmain.main(args, log=lambda m: None)
        torch.cuda.synchronize()
        launches = kernel_launches()
    finally:
        ptrain.make_dp_rollout = orig_rollout
        pmain.make_dp_train_step = orig_step
    wall_s = time.time() - t0

    # the one-process --device_rollout rollout and step on this rank's batch
    engine = seen["engine"]
    zero_launches()
    with torch.no_grad():
        scene = engine.run_backbone(seen["batch"], training=True)
        max_label = cfg.model.max_fg_objects
        gen = torch.Generator(device=dev).manual_seed(0)
        cs, counts = train_rollout(
            engine.model, scene, seen["labels"], seen["num_obj"],
            seen["num_iters"], gen,
            engine._click_bucket((seen["num_iters"] + 1) * max_label),
            max_label)
    del scene
    one_rollout = kernel_launches()
    opt, _ = make_optimizer(engine.model, cfg, 1)
    zero_launches()
    make_train_step(cfg, engine.model, opt)(
        engine.device_batch(seen["batch"]),
        device_click_state(cs, counts, cfg.model.max_clicks), seen["labels"],
        seen["num_obj"])
    torch.cuda.synchronize()
    one_step = kernel_launches()
    same_loss = float(pmax(torch.tensor(seen["steps"][0]["loss"]),
                           mesh["dp"])) == seen["steps"][0]["loss"]
    return dict(identical=identical, launches=launches, wall_s=wall_s,
                steps=seen["steps"], num_iters=seen["num_iters"],
                rollout_launches=seen["rollout_launches"],
                one_rollout_launches=one_rollout,
                one_step_launches=one_step, same_loss=same_loss,
                epoch_loss=(history["epochs"][0]["loss"] if history
                            else None),
                rows=seen["batch"].pyramid.levels[0].grid.shape[0])


def _parallel_rank(scans, val_list, dp_scans, dp_list, tmp):
    """One rank of the parallel phase's gloo group (both on the one
    card)."""
    import torch
    import torch.distributed as dist

    from agile3d_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    rank = dist.get_rank()
    t0 = time.time()
    mesh = make_mesh(n_dp=1, n_sp=PARALLEL_RANKS, device=DEVICE)
    out = {"decoder": _sp_decoder_rank(torch, mesh, scans, val_list)}
    torch.cuda.empty_cache()
    for key, bb in (("sp_eval", False), ("sp_backbone_eval", True)):
        out[key] = _sp_eval_rank(torch, scans, val_list,
                                 os.path.join(tmp, f"par_{key}"), bb)
        if rank == 0:
            out[key]["rows"] = _csv_rows(os.path.join(tmp, f"par_{key}"))
        torch.cuda.empty_cache()
    out["dp"] = _dp_rank(torch, dp_scans, dp_list,
                         os.path.join(tmp, "par_dp"))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.time() - t0
    return out


def _nccl_on_one_card(tmp) -> dict:
    """What NCCL does with two ranks on one card, in a child process group
    that is killed whole after 120 s: the port refuses that layout before
    starting a process (``parallel/mesh.py::check_layout``); this asks
    NCCL itself, bypassing the check. The ranks' code is a script file,
    so that the spawn start method can import it."""
    script = os.path.join(tmp, "nccl_two_ranks.py")
    with open(script, "w") as f:
        f.write(
            "import sys, torch, torch.distributed as dist\n"
            "import torch.multiprocessing as mp\n"
            "def rank(r, path):\n"
            "    torch.cuda.set_device(0)\n"
            "    dist.init_process_group('nccl', store=dist.FileStore(path, 2),"
            " rank=r, world_size=2)\n"
            "    t = torch.ones(1, device='cuda')\n"
            "    dist.all_reduce(t)\n"
            "    torch.cuda.synchronize()\n"
            "    print('rank', r, 'all_reduce', float(t), flush=True)\n"
            "    dist.destroy_process_group()\n"
            "if __name__ == '__main__':\n"
            "    mp.start_processes(rank, args=(sys.argv[1],), nprocs=2,"
            " start_method='spawn')\n")
    proc = subprocess.Popen(
        [sys.executable, script, os.path.join(tmp, "nccl_store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, env=dict(os.environ, NCCL_DEBUG="WARN"))
    try:
        out, _ = proc.communicate(timeout=120)
        status = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        status = "killed after 120 s"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    # NCCL's refusal, or a rank's line after its all-reduce
    said = [ln for ln in lines
            if "Duplicate GPU" in ln or ln.startswith("rank ")]
    return {"exit": status, "said": said[:1], "reached_nccl": bool(said)}


def phase_parallel(torch, scans, val_list, tmp):
    """The parallel paths on the one card, as two ``gloo`` ranks sharing it
    (function and memory, not scaling): the voxel-sharded decoder at the
    smoke scene against the one-process one; ``eval_multi_obj --sp 2`` and
    ``--sp 2 --sp_backbone`` against the one-process device rollout at
    SP_CLICKS clicks an object; ``main --num_dp 2`` (one identical-groups
    step against the one-process step first); in this process,
    ``--scene_parallel 2`` (one card: one device) against the serial host
    loop, and ``--sp 2`` without a group refused on nccl in one line."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.cli import run
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.parallel.mesh import spawn

    t0 = time.time()
    quiet = lambda m: None
    parse = eval_multi_obj.get_args_parser().parse_args
    one = {}
    for name, extra in (("device", []), ("host", ["--host_rollout"]),
                        ("scene_parallel", ["--scene_parallel",
                                            str(PARALLEL_RANKS)])):
        out = os.path.join(tmp, f"par_one_{name}")
        zero_launches()
        eval_multi_obj.main(parse(_eval_argv(scans, val_list, out, *extra)),
                            log=quiet)
        torch.cuda.synchronize()
        one[name] = dict(rows=_csv_rows(out), launches=kernel_launches())

    err = io.StringIO()
    code = None
    try:
        with contextlib.redirect_stderr(err):
            run(eval_multi_obj.get_args_parser(), eval_multi_obj.main,
                _eval_argv(scans, val_list, os.path.join(tmp, "par_refused"),
                           "--sp", str(PARALLEL_RANKS)))
    except SystemExit as e:
        code = e.code
    refusal = err.getvalue().strip().splitlines()

    dp_scans, dp_list = write_benchmark(os.path.join(tmp, "dp"), **DP_SCENES)
    t1 = time.time()
    ranks = spawn(_parallel_rank, PARALLEL_RANKS, scans, val_list, dp_scans,
                  dp_list, tmp, backend="gloo", device=DEVICE)
    ranks_s = time.time() - t1
    nccl = _nccl_on_one_card(tmp)

    dec = [r["decoder"] for r in ranks]
    want = one["device"]["rows"]

    def iou_diff(rows):
        check(len(rows) == len(want)
              and [r[:4] for r in rows] == [r[:4] for r in want],
              "a sharded rollout wrote other rows than the one-process one")
        return max(abs(float(a[4]) - float(b[4])) for a, b in zip(rows, want))

    rounds = len(want) - 1
    sp = {k: dict(iou_max_diff=iou_diff(ranks[0][k]["rows"]),
                  wall_s=[r[k]["wall_s"] for r in ranks],
                  launches=[r[k]["launches"] for r in ranks])
          for k in ("sp_eval", "sp_backbone_eval")}
    halo = ranks[0]["sp_backbone_eval"]["halo"]
    dp = [r["dp"] for r in ranks]
    emit({"phase": "parallel", "ranks": PARALLEL_RANKS, "backend": "gloo",
          "note": "two ranks share one card: function and memory, not "
                  "scaling",
          "decoder": dec, "sp": sp, "rounds": rounds,
          "halo_exchanges": halo,
          "dp": [{k: d[k] for k in ("identical", "launches", "wall_s",
                                    "steps", "num_iters", "rollout_launches",
                                    "one_rollout_launches",
                                    "one_step_launches", "epoch_loss",
                                    "rows")} for d in dp],
          "scene_parallel_rows_equal": one["scene_parallel"]["rows"]
          == one["host"]["rows"],
          "refusal": {"exit_code": code, "stderr": refusal},
          "nccl_two_ranks_one_card": nccl,
          "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
          "rank_seconds": [r["seconds"] for r in ranks],
          "ranks_wall_s": ranks_s, "seconds": time.time() - t0})

    for d in dec:
        check(d["band_ratio"] <= 1.0 and d["labels_equal_where_clear"],
              f"sharded decoder off the one-process one: {d}")
    for k, v in sp.items():
        check(v["iou_max_diff"] <= 1e-4, f"{k}: IoU differs by "
                                         f"{v['iou_max_diff']}")
        for lc in v["launches"]:
            # every rank runs round 0's call, then one a round
            check(lc["boundary_distances_all"] == rounds + 1,
                  f"{k}: distance launches {lc} != {rounds} rounds + 1")
            check(lc["banded_window_conv"] == lc["smem_row_gather"] == 0,
                  f"{k}: a probe kernel ran: {lc}")
            if k == "sp_eval":
                check(lc["banded_conv"] == 8 and lc["banded_stem"] == 1,
                      f"{k}: the one-process backbone's launches {lc}")
            else:
                check(lc["banded_conv"] == 0 and lc["banded_stem"] == 0,
                      f"{k}: the sharded backbone launched a banded kernel "
                      f"{lc}")
    check(len(halo) > 0 and all(h["halo_rows"] > 0 for h in halo),
          f"no halo exchange recorded: {halo}")
    for d in dp:
        i = d["identical"]
        check(i["loss_diff"] <= DP_LOSS_TOL and i["miou_diff"] <= DP_LOSS_TOL
              and i["param_excess"] <= DP_PARAM_TOL["atol"],
              f"dp step on identical groups vs one process: {i}")
        check(d["same_loss"] and len(d["steps"]) == 1,
              f"dp epoch: {d['steps']}")
        per = {k: d["rollout_launches"][k] + d["steps"][0]["launches"][k]
               for k in d["launches"]}
        one_path = {k: d["one_rollout_launches"][k] + d["one_step_launches"][k]
                    for k in d["launches"]}
        check(per == one_path == d["launches"],
              f"dp launches {per} (epoch {d['launches']}) != the one-process "
              f"device-rollout step's {one_path}")
        check(d["launches"]["boundary_distances_all"] == d["num_iters"] + 1
              and d["launches"]["banded_conv"] > 0
              and d["launches"]["banded_conv_dw"] > 0,
              f"dp launches {d['launches']}")
    check(one["scene_parallel"]["rows"] == one["host"]["rows"],
          "--scene_parallel rows differ from the serial host loop's")
    check(nccl["reached_nccl"],
          f"the two-ranks-on-one-card probe did not reach NCCL: {nccl}")
    check(code == 1 and len(refusal) == 1 and refusal[0].startswith(
        f"error: {PARALLEL_RANKS} ranks on nccl need"),
          f"--sp {PARALLEL_RANKS} on one card without a group: exit {code}, "
          f"{refusal}")
    sum_ranks = lambda lcs: {k: sum(lc[k] for lc in lcs) for k in lcs[0]}
    return {"sp_eval": sum_ranks(sp["sp_eval"]["launches"]),
            "sp_backbone_eval": sum_ranks(sp["sp_backbone_eval"]["launches"]),
            "dp_train": sum_ranks([d["launches"] for d in dp])}


# the regime in miniature (train_regime): 5 train and 2 val scenes of
# 30,000 points (2 objects, to hold the validations' time), 4 epochs of 1
# step, the drop at 3 and validation every 2. The first piece is cut
# (TERM, the wall-clock bound's path) once main logs epoch REGIME_CUT_AFTER
# done, after that epoch's validation: the cut falls in epoch 2's training,
# never inside a validation. REGIME_BOUND_S bounds the piece's wall clock
# (~41 s on an H100) in case that line never comes
REGIME = dict(scenes=5, val_scenes=2, n_points=30000, num_obj=2, epochs=4,
              lr_drop_frac=0.75, val_epochs=2)
REGIME_CUT_AFTER = 1
REGIME_BOUND_S = 240.0
# stress_kitti at the KITTI-360 size, 3 timed passes of each part
STRESS_ARGS = ["--points", "1200000", "--reps", "3"]
# compare_rollout_paths on 2 scenes of 50,000 points, 4 objects, 3 clicks
# an object
ROLLOUT_GROUPS = "2x4x50000"
ROLLOUT_CLICKS = 3


def _val_banded_levels(scans, val_list):
    """Per val scene, read from ``scans`` as ``main`` reads it (one-scene
    eval batches): the levels whose k3 convs take B1, and whether its stem
    takes B2."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.models.backbone import BANDED_MIN_ROWS

    cfg = Config()
    ds = InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)
    out = []
    for i in range(len(ds)):
        pyr = collate_scenes([ds[i]], cfg.buckets).pyramid
        out.append((_banded_levels(pyr),
                    int(pyr.levels[0].k5.shape[0] >= BANDED_MIN_ROWS)))
    return out


def phase_regime(torch, tmp):
    """``python -m agile3d_torch.tools.train_regime`` (its ``main``, in
    process; it runs ``python -m agile3d_torch.main`` as a child) at a
    miniature of the regime: a first piece cut once epoch
    ``REGIME_CUT_AFTER`` is done (in epoch 2's training), then
    ``--resume`` from its last checkpoint. Both val curves must come out
    (one from each piece), the LR must read 1e-5 from the drop on, the
    optimizer must have taken every step, and the kernels' launches (from
    the children's logs) must be the routing rule's: 12 B1 and 4 B3 a step
    for each banded level (3 B1 to a B3), 4 B1 a banded level and 1 B2 for
    each val scene's eval forward, and at least one distance launch a step
    (the device rollout's rounds, 1-20)."""
    from agile3d_torch.tools import train_regime

    t0 = time.time()
    flags = ["--device", DEVICE] + [
        a for k, v in REGIME.items() for a in (f"--{k}", str(v))]
    lines = []
    work = os.path.join(tmp, "regime")
    argv = [work] + flags
    first = train_regime.main(argv + ["--max_seconds", str(REGIME_BOUND_S)],
                              log=lines.append,
                              stop_after_epoch=REGIME_CUT_AFTER)
    ckpt = train_regime.last_checkpoint(work)
    check(first["pieces"][0]["cut"] and ckpt is not None
          and REGIME_CUT_AFTER in first["pieces"][0]["epochs_done"],
          f"regime: the first piece was not cut after epoch "
          f"{REGIME_CUT_AFTER} with a checkpoint: {first['pieces'][0]}, "
          f"{lines[-3:]}")
    second = train_regime.main(argv + ["--resume", ckpt], log=lines.append)
    pieces = second["pieces"]
    epochs, steps_per_epoch = REGIME["epochs"], REGIME["scenes"] // 5
    steps = second["steps"]
    lc = second["launches"]
    # main validates from the train scan folder (the val scans are linked
    # in where their names are free)
    val_levels = _val_banded_levels(os.path.join(work, "train", "scans"),
                                    os.path.join(work, "val",
                                                 "val_list.json"))
    child_vals = len(second["val_curves"])
    eval_b1 = child_vals * sum(4 * n for n, _ in val_levels)
    eval_b2 = child_vals * sum(s for _, s in val_levels)
    lr = {int(e): v for e, v in second["lr_by_epoch"].items()}
    drop = train_regime.lr_drop_epoch(epochs, REGIME["lr_drop_frac"])
    emit({"phase": "regime", "config": REGIME,
          "cut_after_epoch": REGIME_CUT_AFTER,
          "pieces": [{k: p[k] for k in ("exit", "wall_s", "cut", "resume",
                                         "resumed_from", "epochs_done",
                                         "steps", "launches")}
                     for p in pieces],
          "steps": steps, "steps_per_s": steps / sum(
              p["wall_s"] for p in pieces),
          "lr_by_epoch": lr,
          "val_curves": {e: {m: finite(v) for m, v in c.items()}
                         for e, c in second["val_curves"].items()},
          "launches": lc, "launches_per_step": {
              "banded_conv": (lc["banded_conv"] - eval_b1) / max(steps, 1),
              "banded_conv_dw": lc["banded_conv_dw"] / max(steps, 1),
              "boundary_distances_all":
                  lc["boundary_distances_all"] / max(steps, 1)},
          "val_banded_levels": val_levels,
          "lost_validations": second["lost_validations"],
          "device": second["device"], "seconds": time.time() - t0})
    check(len(pieces) == 2 and pieces[0]["cut"] and not pieces[1]["cut"]
          and pieces[1]["exit"] == 0 and second["in_pieces"],
          f"regime: not one cut piece and one resumed to the end: {pieces}")
    check(pieces[0]["epochs_done"] and pieces[1]["resume"] == ckpt
          and not second["lost_validations"],
          f"regime: the cut piece finished no epoch, or a validation was "
          f"lost: {pieces[0]}, {second['lost_validations']}")
    check(sorted(int(e) for e in second["val_curves"])
          == list(range(REGIME["val_epochs"] - 1, epochs,
                        REGIME["val_epochs"])),
          f"regime: val curves at {sorted(second['val_curves'])}")
    check(all(math.isfinite(v["IoU@1"]) for v in
              second["val_curves"].values()), "regime: a non-finite IoU@1")
    check(lr.get(0) == 1e-4 and lr.get(drop) == 1e-5
          and lr.get(epochs - 1) == 1e-5,
          f"regime: LR by epoch {lr}, the drop at {drop}")
    check(steps == epochs * steps_per_epoch,
          f"regime: {steps} steps, not {epochs * steps_per_epoch}")
    ran = sum(len(p["epochs_done"]) for p in pieces) * steps_per_epoch
    check(lc["banded_conv_dw"] % 4 == 0
          and 4 * ran <= lc["banded_conv_dw"] <= 8 * ran
          and lc["banded_conv"] == 3 * lc["banded_conv_dw"] + eval_b1
          and lc["banded_stem"] == eval_b2,
          f"regime: launches {lc} for {ran} steps and {child_vals} "
          f"validations (eval B1 {eval_b1}, B2 {eval_b2})")
    check(ran <= lc["boundary_distances_all"] <= 20 * ran,
          f"regime: {lc['boundary_distances_all']} distance launches for "
          f"{ran} steps")
    check(lc["banded_window_conv"] == lc["smem_row_gather"] == 0,
          f"regime: a probe kernel ran: {lc}")
    return lc


def phase_stress(torch):
    """``python -m agile3d_torch.tools.stress_kitti`` (its ``run``, in
    process) at 1.2M points over 22 m (the 786,432-row bucket): the chunked
    attention engaged as the rule picks it, finite masks, the footprint of
    one backbone and one decoder pass under the oversize guard's estimate,
    and 4 B1 a banded level and 1 B2 a backbone pass."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch.tools import stress_kitti

    t0 = time.time()
    zero_launches()
    lines = []
    res = stress_kitti.run(stress_kitti.get_args_parser().parse_args(
        STRESS_ARGS + ["--device", DEVICE]), log=lines.append)
    torch.cuda.synchronize()
    launches = kernel_launches()
    passes = res["backbone_passes"]
    emit({"phase": "stress", **{k: res[k] for k in (
        "voxels", "rows", "host_prep_s", "backbone_first_s", "backbone_ms",
        "forward_mask_ms", "chunk", "chunk_rule", "footprint_gib",
        "estimate_gib", "footprint_bytes_per_row", "run_peak_gib",
        "banded_levels", "backbone_passes", "device")},
        "launches": launches, "seconds": time.time() - t0})
    check(res["rows"] == KITTI_ROWS, f"stress: {res['rows']} rows")
    check(res["chunk"] > 0 and res["chunk"] == res["chunk_rule"],
          f"stress: chunk {res['chunk']}, the rule's {res['chunk_rule']}")
    check(res["finite"], "stress: non-finite masks")
    check(res["footprint_gib"] <= res["estimate_gib"],
          f"stress: footprint {res['footprint_gib']} GiB over the guard's "
          f"estimate {res['estimate_gib']} GiB")
    want = {"banded_conv": 4 * res["banded_levels"] * passes,
            "banded_stem": passes}
    check(all(launches[k] == v for k, v in want.items())
          and launches["boundary_distances_all"] == 0
          and launches["banded_conv_dw"] == 0
          and launches["banded_window_conv"] == launches[
              "smem_row_gather"] == 0,
          f"stress: launches {launches}, want {want}")
    return launches


def phase_rollout_paths(torch, tmp):
    """``python -m agile3d_torch.tools.compare_rollout_paths`` (its
    ``compare``, in process) on ROLLOUT_GROUPS at ROLLOUT_CLICKS clicks an
    object, random weights: no trajectory diverges, the two rollouts'
    ``EvaluatorMO`` dicts are equal, one distance launch a trajectory's
    round 0 and a device round and none in the host loop, one eval
    backbone a scene on each."""
    from agile3d_torch.utils.profiling import kernel_launches
    from agile3d_torch.tools import compare_rollout_paths

    t0 = time.time()
    zero_launches()
    res = compare_rollout_paths.compare(
        os.path.join(tmp, "rollout_cmp"), groups=ROLLOUT_GROUPS,
        clicks=ROLLOUT_CLICKS, seed=42, checkpoint=None, device=DEVICE,
        log=lambda *a: None)
    torch.cuda.synchronize()
    launches = kernel_launches()
    same = lambda a, b: a == b or (math.isnan(a) and math.isnan(b))
    equal = res["host"].keys() == res["dev"].keys() and all(
        same(res["host"][k], res["dev"][k]) for k in res["host"])
    lc = res["launches"]
    emit({"phase": "rollout_paths", "groups": ROLLOUT_GROUPS,
          "clicks": ROLLOUT_CLICKS, "n_diverged": res["n_diverged"],
          "n_traj": res["n_traj"], "first_divergence":
          res["first_divergence"],
          # NoC@k is NaN below 20 clicks an object
          **{k: {m: finite(v) for m, v in res[k].items()}
             for k in ("host", "dev")},
          "times": res["times"], "rounds": res["rounds"], "launches": lc,
          "device": res["device"], "seconds": time.time() - t0})
    check(res["n_diverged"] == 0 and equal,
          f"rollout paths: {res['n_diverged']} trajectories diverged; "
          f"host {res['host']} dev {res['dev']}")
    scenes = int(ROLLOUT_GROUPS.split("x")[0])
    for name in ("host", "dev"):
        check(lc[name]["banded_stem"] == scenes
              and lc[name]["banded_conv"] % (4 * scenes) == 0
              and lc[name]["banded_conv"] > 0,
              f"rollout paths ({name}): backbone launches {lc[name]}")
    # a trajectory's round 0, then one a device round
    check(lc["host"]["boundary_distances_all"] == 0
          and lc["dev"]["boundary_distances_all"]
          == res["rounds"] + res["n_traj"],
          f"rollout paths: distance launches {lc}, device rounds "
          f"{res['rounds']} + {res['n_traj']} round 0s")
    return launches


# measure_sp_hbm at the stress scene (786,432 rows) on two ranks
SP_HBM_ARGS = ["--points", "1200000", "--extent", "22", "--sp", "2"]
# the reference phase's bound on the banded kernels' bf16 operands against
# plain f32, per unit of (largest value + 1)
KERNEL_FEATURE_TOL = 5e-2
# bench_dp_scaling at widths 1 and 2, 2 steps an epoch (the tool: 1, 2, 4,
# 8 and 8 steps)
DP_SCALING_WIDTHS = (1, 2)
DP_SCALING_STEPS = 2


def phase_sp_hbm(torch):
    """``python -m agile3d_torch.tools.measure_sp_hbm`` (its ``run``, in
    process) at the stress scene on 2 ranks: the one-process eval backbone
    launches 8 B1 and 1 B2, the sharded one none; each rank's peak is below
    the one process's; the ranks' scene features, gathered back, equal the
    one-process pass of the plain convs (the sharded backbone's arithmetic)
    within the sharded backbone's bounds (``measure_sp_hbm.FEATURE_TOL``:
    ``tests/test_torch_parallel_backbone.py``'s mask_feat 2e-4, pos_pcd
    1e-5, cmin / cmax 1e-6), and the pass with the kernels within the
    reference phase's bound on their bf16 operands."""
    from agile3d_torch.tools import measure_sp_hbm
    from agile3d_torch.utils.profiling import kernel_launches

    t0 = time.time()
    zero_launches()
    lines = []
    res = measure_sp_hbm.run(measure_sp_hbm.get_args_parser().parse_args(
        SP_HBM_ARGS + ["--device", DEVICE]), log=lines.append, compare=True)
    torch.cuda.synchronize()
    here = kernel_launches()
    single, ranks = res["single"], res["sp_ranks"]
    launches = {k: here[k] + ranks["launches"][k] for k in here}
    emit({"phase": "sp_hbm", **{k: res[k] for k in (
        "voxels", "rows", "sp", "host_prep_s", "partition_s", "halo0_rows",
        "halo0_live", "halo0_share", "reduction", "plain_max_abs_diff",
        "kernel_max_abs_diff", "mask_feat_scale", "within_tol", "device")},
        "single": single, "sp_ranks": ranks, "single_gib":
        single["peak_bytes"] / 2 ** 30, "rank_gib": [
            b / 2 ** 30 for b in ranks["peak_bytes"]],
        "launches": launches, "lines": lines[:-1],
        "seconds": time.time() - t0})
    check(res["rows"] == KITTI_ROWS, f"sp_hbm: {res['rows']} rows")
    check(single["launches"]["banded_conv"] == 8
          and single["launches"]["banded_stem"] == 1
          and here == single["launches"],
          f"sp_hbm: one-process launches {single['launches']}, in this "
          f"process {here}: want 8 B1 and 1 B2, none in the plain pass")
    check(set(ranks["launches"].values()) == {0},
          f"sp_hbm: the sharded backbone launched {ranks['launches']}")
    check(all(b < single["peak_bytes"] for b in ranks["peak_bytes"]),
          f"sp_hbm: rank peaks {ranks['peak_bytes']} not below the one "
          f"process's {single['peak_bytes']}")
    check(res["within_tol"],
          f"sp_hbm: sharded features vs the one-process plain pass "
          f"{res['plain_max_abs_diff']} over {measure_sp_hbm.FEATURE_TOL}")
    check(res["kernel_max_abs_diff"]["mask_feat"]
          <= KERNEL_FEATURE_TOL * (res["mask_feat_scale"] + 1),
          f"sp_hbm: sharded mask features vs the kernel pass "
          f"{res['kernel_max_abs_diff']} (scale {res['mask_feat_scale']})")
    return launches


def phase_dp_scaling(torch):
    """``python -m agile3d_torch.tools.bench_dp_scaling`` (its ``run``, in
    process) at widths DP_SCALING_WIDTHS, DP_SCALING_STEPS steps an epoch:
    both epochs of each width finite, and the device rollout's distance
    kernel launched once a round on each rank (3 rounds a step), nothing
    else (no banded level at 8 channels). Two gloo ranks share the card:
    the times are not scaling."""
    from agile3d_torch.tools import bench_dp_scaling

    t0 = time.time()
    lines = []
    res = bench_dp_scaling.run(widths=DP_SCALING_WIDTHS,
                               steps=DP_SCALING_STEPS, device=DEVICE,
                               log=lines.append)
    rows = res["rows"]
    launches = {k: sum(e[k] for row in rows for e in row["launches"])
                for k in rows[0]["launches"][0]}
    emit({"phase": "dp_scaling", "table": lines[:-1], "rows": rows,
          "launches": launches, "device": res["device"],
          "seconds": time.time() - t0})
    for row in rows:
        d = row["dp"]
        check(math.isfinite(row["epoch_wall_s"])
              and math.isfinite(row["warm_wall_s"])
              and all(math.isfinite(v) for v in row["stats"].values()),
              f"dp_scaling: width {d} not finite: {row}")
        want = res["rollout_rounds"] * DP_SCALING_STEPS * d
        for epoch in row["launches"]:
            others = {k: v for k, v in epoch.items()
                      if k != "boundary_distances_all"}
            check(epoch["boundary_distances_all"] == want
                  and set(others.values()) == {0},
                  f"dp_scaling: width {d} launched {epoch}, want {want} "
                  f"distance launches and nothing else")
    return launches


def kernel_meta():
    """Per kernel of the port: (source, the TPU kernel or XLA fusion it
    replaces, the rows' roles that its times sum, the unit of those
    times)."""
    # launches: each path's runs (counts zeroed just before each, read just
    # after); the times: the training step's work for the k3 kernel and
    # dW, one eval backbone forward for the stem; for the window kernel the
    # eval backbone's eight k3 convs in banded_conv's place, for the row
    # gather the TPU probe's shape from both tables, for the boundary
    # distance one eval round
    return {
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
            ("probe shape",),
            "27 x 1024 rows from a 384 x 128 and from a 4,096 x 128 f32 "
            "table"),
        "boundary_distances_all": (
            "agile3d_torch/csrc/boundary_dist.cu",
            tpu_kernel("device_eval.py", "_boundary_distances_all"),
            ("eval round",),
            "one eval round of the smoke scene, its error rows queried "
            "(an XLA fusion's counterpart, not a Pallas kernel's; no "
            "library call computes it)"),
    }


def _summary(rows, roles):
    """Sums over the rows of ``roles``, each weighted by its count."""
    mine = [r for r in rows if r["role"] in roles]
    total = lambda key: sum(r[key] * r["count"] for r in mine)
    by_ops = sum(r["bound_ms"] * r["count"] for r in mine
                 if r["bound_by"] == "operations")
    shape = lambda r: r.get("shape") or f"{r['rows']}x{r['cin']}->{r['cout']}"
    return {"max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if by_ops >= total("bound_ms") / 2
                         else "bytes"),
            # null where no single library call computes the function
            "library_ms": (None if any(r["library_ms"] is None for r in mine)
                           else total("library_ms")),
            "shapes": ", ".join(f"{r['count']}x {shape(r)} ({r['role']})"
                                for r in mine)}


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
    laps, mark = {}, [t_start]

    def lap(name):
        """The wall time since the last lap, under ``name``."""
        now = time.time()
        laps[name] = now - mark[0]
        mark[0] = now

    phase_device(torch, cuda_build)
    lap("device")
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
        ref_scans, ref_list = write_benchmark(os.path.join(tmp, "kref"),
                                              **TRAIN_REF_SCENES)
        ref_ds = InterMultiObjDataset(ref_scans, ref_list,
                                      cfg.model.voxel_size)
        ref_pyr = collate_scenes([ref_ds[i] for i in range(len(ref_ds))],
                                 cfg.buckets).pyramid
        eval_dev = to_device(eval_batch.pyramid, DEVICE)
        lap("scenes")
        shapes = phase_kernels(torch, kernel_cases(
            eval_dev, to_device(train_batch.pyramid, DEVICE),
            to_device(ref_pyr, DEVICE)))
        shapes += phase_distances(torch, distance_cases(eval_batch,
                                                        train_batch))
        lap("kernels")
        phase_round0(torch, eval_batch)
        lap("round0")
        probe_rows, probe_launches = phase_probes(torch, eval_batch.pyramid,
                                                  eval_dev)
        lap("probes")
        phase_decoder(torch, eval_batch)
        lap("decoder")
        del eval_dev, train_batch, train_ds, ref_ds, ref_pyr
        torch.cuda.empty_cache()
        phase_reference(torch, tmp)
        lap("reference")
        train_run, train_compare, n_lv = phase_train_reference(torch, tmp)
        lap("train_reference")
        bf16_launches = phase_bf16_backbone(torch, eval_batch, train_run,
                                            train_compare, n_lv)
        lap("bf16_backbone")
        dropout_launches = phase_dropout(torch, train_run, n_lv)
        lap("dropout")
        del train_run, train_compare
        with native_host_prep("eval"):
            eval_launches = phase_main_path(torch, scans, val_list,
                                            os.path.join(tmp, "out"))
        lap("eval")
        oversize_launches = phase_oversize(torch, scans, val_list, tmp)
        lap("oversize")
        with native_host_prep("single"):
            single_launches = phase_single(torch, scans, tmp)
        lap("single")
        with native_host_prep("serve"):
            serve_launches = phase_serve(torch, scans, tmp)
        lap("serve")
        variant_launches = phase_variants(torch, eval_batch, scans, val_list,
                                          tmp)
        lap("variants")
        phase_memory(torch, eval_batch, tmp)
        lap("memory")
        del eval_batch
        with native_host_prep("train"):
            host_train = phase_train_main_path(torch, train_scans,
                                               train_list, tmp)
        lap("train")
        with native_host_prep("train_device_rollout"):
            device_train = phase_train_device_rollout(torch, train_scans,
                                                      train_list, tmp)
        lap("train_device_rollout")
        with native_host_prep("resume"):
            resume_launches = phase_resume(torch, tmp)
        lap("resume")
        torch.cuda.empty_cache()
        with native_host_prep("parallel"):
            parallel_launches = phase_parallel(torch, scans, val_list, tmp)
        lap("parallel")
        torch.cuda.empty_cache()
        regime_launches = phase_regime(torch, tmp)
        lap("regime")
        with native_host_prep("stress"):
            stress_launches = phase_stress(torch)
        lap("stress")
        torch.cuda.empty_cache()
        with native_host_prep("rollout_paths"):
            rollout_launches = phase_rollout_paths(torch, tmp)
        lap("rollout_paths")
        torch.cuda.empty_cache()
        with native_host_prep("sp_hbm"):
            sp_hbm_launches = phase_sp_hbm(torch)
        lap("sp_hbm")
        torch.cuda.empty_cache()
        dp_scaling_launches = phase_dp_scaling(torch)
        lap("dp_scaling")
        # bench_train also assembles batches on the numpy path, for its
        # numpy_host times
        with native_host_prep("benches", numpy_too=True):
            bench_launches, _ = phase_benches(torch)
        lap("benches")

    meta = kernel_meta()
    paths = {"probe": probe_launches, "eval": eval_launches,
             "eval_oversize": oversize_launches,
             "single": single_launches, "serve": serve_launches,
             "variants": variant_launches,
             "train": host_train, "train_device_rollout": device_train,
             "bf16_backbone": bf16_launches, "dropout": dropout_launches,
             "resume": resume_launches, **parallel_launches,
             "regime": regime_launches, "stress": stress_launches,
             "rollout_paths": rollout_launches,
             "sp_hbm": sp_hbm_launches, "dp_scaling": dp_scaling_launches,
             "bench": bench_launches["bench"],
             "bench_train": bench_launches["bench_train"]}
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
        variant = [r for r in mine if r["role"].startswith("variant")]
        if variant:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(r["max_abs_err"] for r in variant))
            entry["variant_shapes"] = [{k: r[k] for k in (
                "role", "rows", "cin", "cout", "max_abs_err", "tol", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for r in variant]
        bf16 = [r for r in mine if r["role"].startswith("bf16")]
        if bf16:
            entry["bf16_shapes"] = [{k: r[k] for k in (
                "role", "rows", "cin", "cout", "count", "max_abs_err", "tol",
                "bit_equal_f32", "ms", "f32_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for r in bf16]
        if name == "banded_stem":
            entry["prep_ms"] = sum(r["prep_ms"] * r["count"] for r in mine
                                   if not r["role"].startswith("bf16"))
        if name == "banded_window_conv":
            entry["banded_conv_ms"] = sum(r["banded_conv_ms"] * r["count"]
                                          for r in mine)
        if name == "smem_row_gather":
            entry["by_table"] = {r["table_rows"]: {k: r[k] for k in (
                "ms", "floor_ms", "store_ms",
                "plain_ms", "library_ms", "bound_ms")} for r in mine}
        if name == "boundary_distances_all":
            tr = _summary(mine, ("train round",))
            entry["per_train_round"] = {k: tr[k] for k in (
                "ms", "plain_ms", "bound_ms", "shapes")}
            # pairs evaluated of the all-pairs count, and the parent
            # commit's kernel where AGILE3D_PARENT names one (its main
            # path computed every row)
            entry["by_role"] = {r["role"]: {k: r[k] for k in (
                "shape", "query_rows", "pairs", "all_pairs", "pairs_share",
                "ms", "parent_ms", "plain_ms", "bound_ms")} for r in mine}
        kernels.append(entry)
    emit({"phase_seconds": laps})
    emit({"total_s": time.time() - t_start})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
