"""The data-parallel epoch driver's table at widths 1, 2, 4 and 8:
counterpart of the repository's ``tools/bench_dp_scaling.py``, on the port.

Weak scaling: each dp rank takes the same workload at every width (one
scene a step, 8 steps of d scenes), so ideal scaling is a flat wall-clock
per step as d grows. Each width gets fresh ranks (``parallel/mesh.py::
spawn``) on a (d, 1) mesh, the JAX tool's seeded configuration (a backbone
of 8 channels on each of 8 levels, one block each; the decoder at 32;
buckets 512 / 1024 / 2048; 64 scenes of 900 points with 2 objects from
``default_rng(0)``) and its fixed rollout length (``FixedRng.randint`` ->
2: three click rounds a step), and runs ``parallel/train.py::
make_dp_train_step`` and ``dp_train_one_epoch``: a warm epoch, then the
timed one, each from ``default_rng(1)``.

What one card shows is NOT scaling: the ranks share the card (NCCL takes
one rank a card, so they run on ``gloo``) and every collective is staged
through the host, so the per-step time grows with d as the JAX tool's
does on its virtual CPU mesh. What the table validates is that the dp
workflow (per-rank collation, weight-masked tails, the device rollout, the
synchronized step) adds no super-linear overhead as the mesh widens. On a
machine with d cards the ranks run on ``nccl``, one card a rank. The
rollout runs on the device: on the card the boundary-distance kernel
launches once a round on each rank; no level is banded at 8 channels
(``models/backbone.py::BANDED_MIN_CIN``), so B1 and B3 do not launch.

The JAX tool gives its epoch driver all 64 scenes and an order of 8 d of
them; the driver steps over the dataset's length, so below d = 8 the
steps past the order are empty and its collation raises. Here each width's
dataset is its first 8 d scenes, the steps the JAX tool means.

    python -m agile3d_torch.tools.bench_dp_scaling [--device cpu]

It runs on the card unless ``--device cpu`` is given; after the table, the
last line of its output is one JSON object with every number it reports.
"""

from __future__ import annotations

import argparse
import json
import random as pyrandom
import time

import numpy as np
import torch

from agile3d_torch.config import BackboneConfig, Config, ModelConfig, TrainConfig
from agile3d_torch.tools import device_label, rank_backend, resolve_device

WIDTHS = (1, 2, 4, 8)
STEPS = 8
NUM_SCENES, N_POINTS, NUM_OBJ = 64, 900, 2
ROLLOUT_ITERS = 2
# the JAX tool's optimizer schedule
STEPS_PER_EPOCH = 4


def dp_config() -> Config:
    """The JAX tool's configuration."""
    small_bb = BackboneConfig(init_dim=8, planes=(8,) * 8, layers=(1,) * 8)
    return Config(model=ModelConfig(max_clicks=32, hidden_dim=32,
                                    dim_feedforward=64, num_heads=2,
                                    backbone=small_bb),
                  train=TrainConfig(batch_size=1, prefetch=2),
                  buckets=(512, 1024, 2048))


def dp_scenes(cfg: Config, n: int = NUM_SCENES) -> list:
    """The JAX tool's scenes: ``n`` synthetic rooms of 900 points and 2
    objects from ``default_rng(0)``, quantized at the model's voxel
    size."""
    from agile3d_torch.data.datasets import SceneSample
    from agile3d_torch.data.synthetic import make_scene
    from agile3d_torch.sparse.quantize import sparse_quantize

    rng = np.random.default_rng(0)
    scenes = []
    for i in range(n):
        coords, colors, labels = make_scene(rng, n_points=N_POINTS,
                                            num_obj=NUM_OBJ)
        vox, umap, imap = sparse_quantize(coords, cfg.model.voxel_size)
        scenes.append(SceneSample(
            vox_coords=vox, raw_coords=coords[umap],
            feats=colors[umap].astype(np.float32) / 255.0,
            labels=labels[umap].astype(np.int32),
            labels_full=labels.astype(np.int32), inverse_map=imap,
            click_idx={}, scene_name=f"s{i}", num_obj=NUM_OBJ))
    return scenes


class FixedRng(pyrandom.Random):
    """The rollout's round count drawn as ``ROLLOUT_ITERS`` every step."""

    def randint(self, a, b):
        return ROLLOUT_ITERS


def epochs_rank(cfg: Config, scenes: list, device: str, epochs: int,
                state_dict=None) -> list:
    """One rank of a width: the seeded model (or ``state_dict``, the
    reference's names), its optimizer and dp step, then ``epochs`` epochs
    of ``dp_train_one_epoch`` over ``scenes`` in their order, each from
    ``default_rng(1)`` and ``FixedRng``. Per epoch: the wall time, the
    averages and this rank's kernel launches."""
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.engine.train import make_optimizer
    from agile3d_torch.models.agile3d import Agile3D, init_agile3d
    from agile3d_torch.parallel.mesh import make_mesh
    from agile3d_torch.parallel.train import dp_train_one_epoch, make_dp_train_step
    from agile3d_torch.utils.ckpt import load_reference_state_dict
    from agile3d_torch.utils.profiling import kernel_launches

    mesh = make_mesh(n_dp=torch.distributed.get_world_size(), n_sp=1,
                     device=device)
    if state_dict is None:
        model = init_agile3d(cfg.model, seed=0, device="cpu")
    else:
        model = Agile3D(cfg.model)
        load_reference_state_dict(model, state_dict)
    engine = InteractiveEngine(cfg, model, mesh.device)
    optimizer, _ = make_optimizer(engine.model, cfg, STEPS_PER_EPOCH)
    step = make_dp_train_step(cfg, engine.model, optimizer, mesh)
    sync = ((lambda: torch.cuda.synchronize(mesh.device))
            if mesh.device.type == "cuda" else (lambda: None))
    out = []
    for epoch in range(epochs):
        before = kernel_launches()
        sync()
        t0 = time.perf_counter()
        stats = dp_train_one_epoch(
            cfg, mesh, engine, step, scenes, 0,
            np_rng=np.random.default_rng(1), py_rng=FixedRng(0),
            log=lambda *a: None, order=np.arange(len(scenes)))
        sync()
        out.append({"wall_s": time.perf_counter() - t0, "stats": stats,
                    "launches": {k: v - before[k]
                                 for k, v in kernel_launches().items()}})
    return out


def run_width(d: int, steps: int, cfg: Config, scenes: list,
              device) -> dict:
    """A warm and a timed epoch of ``steps`` steps of d scenes on d fresh
    ranks: the timed epoch's wall (the slowest rank's), its averages, and
    each epoch's launches summed over the ranks."""
    from agile3d_torch.parallel.mesh import spawn

    backend = rank_backend(device, d)
    ranks = spawn(epochs_rank, d, cfg, scenes[:steps * d], str(device), 2,
                  device=str(device), backend=backend)
    wall = max(r[1]["wall_s"] for r in ranks)
    return {"dp": d, "scenes_per_step": d, "steps": steps,
            "epoch_wall_s": wall, "ms_per_step": 1e3 * wall / steps,
            "scenes_per_s": steps * d / wall, "backend": backend,
            "warm_wall_s": max(r[0]["wall_s"] for r in ranks),
            "stats": ranks[0][1]["stats"],
            "launches": [{k: sum(r[e]["launches"][k] for r in ranks)
                          for k in ranks[0][e]["launches"]}
                         for e in range(2)]}


def run(widths=WIDTHS, steps: int = STEPS, device: str = "",
        log=print) -> dict:
    """The table at ``widths``, ``steps`` steps an epoch; returns the
    result that the last line prints."""
    dev = resolve_device(device or "cuda")
    cfg = dp_config()
    scenes = dp_scenes(cfg)
    if steps * max(widths) > len(scenes):
        raise SystemExit(f"{steps} steps at width {max(widths)} need "
                         f"{steps * max(widths)} of the {len(scenes)} scenes")
    res = {"device": device_label(dev), "rollout_rounds": ROLLOUT_ITERS + 1,
           "rows": []}
    log("dp | scenes/step | steps | epoch wall s | ms/step | scenes/s")
    for d in widths:
        row = run_width(d, steps, cfg, scenes, dev)
        res["rows"].append(row)
        log(f"{d:2d} | {d:11d} | {steps:5d} | {row['epoch_wall_s']:12.1f} | "
            f"{row['ms_per_step']:7.0f} | {row['scenes_per_s']:8.2f}")
    log(json.dumps(res, sort_keys=True))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("the dp epoch driver's table (PyTorch)")
    ap.add_argument("--device", default="",
                    help="'' or 'cuda' (default): the card; 'cpu'")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
