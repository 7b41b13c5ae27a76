"""Rank bodies of the parallel tests (``tests/test_torch_parallel*.py``).

Each function runs in every rank of a group that
``agile3d_torch/parallel/mesh.py::spawn`` starts; the start method pickles
it by import path, so this module imports torch, numpy and the port only
(never JAX). The tests compute their JAX references in the pytest process
and hand them, or the inputs, over as numpy arrays."""

from __future__ import annotations

import random

import numpy as np
import torch

from agile3d_torch.models.agile3d import Agile3D, ClickState, SceneFeatures
from agile3d_torch.parallel.mesh import (
    all_gather,
    axis_index,
    make_mesh,
    pmax,
    pmin,
    psum,
)
from agile3d_torch.utils.ckpt import load_reference_state_dict


def model_from(cfg, sd) -> Agile3D:
    model = Agile3D(cfg)
    load_reference_state_dict(model, sd)
    return model.eval()


def collectives(n_sp: int) -> dict:
    """The collectives on an sp axis of the world, and the dp x sp layouts
    of the world (every rank makes every layout)."""
    mesh = make_mesh(n_dp=1, n_sp=n_sp, device="cpu")
    axis = mesh["sp"]
    r = axis_index(axis)
    x = torch.tensor([1.5 * r, -r, 2.0 ** r])
    out = {"index": r,
           "psum": psum(x, axis).tolist(),
           "pmax": pmax(x, axis).tolist(),
           "pmin": pmin(x, axis).tolist(),
           "gather": all_gather(torch.arange(3) + 10 * r, axis).tolist(),
           "gather_2d": all_gather(torch.full((2, 2), r), axis).tolist(),
           "psum_bf16": psum(torch.tensor([1.0 + r], dtype=torch.bfloat16),
                             axis).dtype == torch.bfloat16,
           "pmax_bool": bool(pmax(torch.tensor(r == 1), axis)),
           "psum_scalar": int(psum(torch.tensor(r + 1), axis))}
    layouts = {}
    world = n_sp
    for n_dp in (1, 2, world):
        if world % n_dp:
            continue
        m = make_mesh(n_dp=n_dp, n_sp=world // n_dp, device="cpu")
        ones = torch.ones(1)
        layouts[n_dp] = {"dp": (m["dp"].size, m["dp"].index),
                         "sp": (m["sp"].size, m["sp"].index),
                         "dp_sum": float(psum(ones, m["dp"])),
                         "sp_sum": float(psum(ones, m["sp"])),
                         "sp_gather": all_gather(
                             torch.tensor([torch.distributed.get_rank()]),
                             m["sp"]).tolist()}
    out["layouts"] = layouts
    # a layout larger than the world, and one smaller
    out["refused"] = []
    for n_dp, n_sp in ((world, 2), (1, 1)):
        try:
            make_mesh(n_dp=n_dp, n_sp=n_sp, device="cpu")
            out["refused"].append(None)
        except ValueError as e:
            out["refused"].append(str(e))
    return out


def _scene(arrays) -> SceneFeatures:
    return SceneFeatures(*(torch.from_numpy(a) for a in arrays))


def sp_decoder(cfg, sd, scene_arrays, clicks, num_obj) -> np.ndarray:
    """This rank's rows of ``forward_mask``'s masks under the sp split of
    the world."""
    from agile3d_torch.parallel.sp import make_forward_mask_sp

    model = model_from(cfg, sd)
    mesh = make_mesh(n_dp=1, n_sp=torch.distributed.get_world_size(),
                     device="cpu")
    fm, shard = make_forward_mask_sp(mesh, cfg)
    out = fm(model, shard(_scene(scene_arrays)),
             ClickState(*(torch.from_numpy(c) for c in clicks)),
             torch.from_numpy(num_obj))
    return out["all_masks"].float().numpy()


def sp_decoder_cases(cases) -> list:
    """``sp_decoder`` for each (cfg, sd, scene arrays, clicks, num_obj) of
    ``cases``, in one group."""
    return [sp_decoder(*case) for case in cases]


def sp_backbone(cfg, sd, batch, training: bool) -> dict:
    """This rank's rows of the sharded backbone's scene features (and, in
    training, the new running statistics by module name)."""
    from agile3d_torch.parallel.sp import shard_rows
    from agile3d_torch.parallel.sp_backbone import (
        local_pyramid,
        make_forward_backbone_sp,
        partition_pyramid,
    )

    model = model_from(cfg, sd)
    world = torch.distributed.get_world_size()
    mesh = make_mesh(n_dp=1, n_sp=world, device="cpu")
    axis = mesh["sp"]
    lv = local_pyramid(partition_pyramid(batch.pyramid, world), axis, "cpu")
    rows = lambda a: shard_rows(torch.from_numpy(a), axis, 0)
    stats = {} if training else None
    scene = make_forward_backbone_sp(mesh, cfg)(
        model, lv, rows(batch.feats), rows(batch.raw), stats)
    out = {k: v.float().numpy() for k, v in scene._asdict().items()}
    if training:
        names = {id(m.bn): n for n, m in model.named_modules()
                 if hasattr(m, "bn")}
        out["bn"] = {names[id(s)]: (mean.numpy(), var.numpy())
                     for s, (mean, var) in stats.items()}
    return out


def sp_backbone_cases(cases) -> list:
    """``sp_backbone`` for each (cfg, sd, batch, training) of ``cases``, in
    one group."""
    return [sp_backbone(*case) for case in cases]


def sp_rollout(cfg, sd, batch, seed: int, max_num_clicks: int,
               sp_backbone_on: bool, host: bool) -> list:
    """The eval rows of one scene with the decoder sharded over the world
    (and the backbone with ``sp_backbone_on``), by the device rollout or
    the host loop."""
    from agile3d_torch.engine.device_eval import evaluate_scene_device
    from agile3d_torch.engine.eval import InteractiveEngine, evaluate_scene

    world = torch.distributed.get_world_size()
    engine = InteractiveEngine(cfg, model_from(cfg.model, sd), "cpu",
                               sp=world, sp_backbone=sp_backbone_on)
    fn = evaluate_scene if host else evaluate_scene_device
    return fn(engine, batch, instance_id=0, rng=random.Random(seed),
              max_num_clicks=max_num_clicks)


def sp_rollout_cases(cases) -> list:
    """``sp_rollout`` for each (cfg, sd, batch, seed, max_num_clicks,
    sp_backbone_on, host) of ``cases``, in one group."""
    return [sp_rollout(*case) for case in cases]


def misc_reduce() -> dict:
    """The metric logger's and ``reduce_dict``'s reductions over the world,
    from values that differ per rank."""
    from agile3d_torch.utils.misc import MetricLogger, reduce_dict

    r = torch.distributed.get_rank()
    logger = MetricLogger()
    for v in range(r + 2):
        logger.update(loss=float(v + 10 * r))
    logger.synchronize_between_processes()
    m = logger.meters["loss"]
    return {"count": m.count, "total": m.total, "global_avg": m.global_avg,
            "reduced": reduce_dict({"b": 1.0 + r, "a": 2.0 * r}),
            "summed": reduce_dict({"b": 1.0 + r}, average=False)}


def _train_parts(cfg, sd):
    from agile3d_torch.engine.train import make_optimizer

    model = model_from(cfg.model, sd)
    optimizer, _ = make_optimizer(model, cfg, 1)
    return model, optimizer


def _step_inputs(batch, clicks):
    from agile3d_torch.sparse.grid import to_device

    t = torch.from_numpy
    return ((to_device(batch.pyramid, "cpu"), t(batch.feats), t(batch.raw),
             t(batch.sample_idx)), ClickState(*(t(c) for c in clicks)),
            t(batch.labels), t(batch.num_obj))


def _state(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in
            model.state_dict().items()}


def _result(out) -> dict:
    return {"loss": float(out["loss"]), "gnorm": float(out["gnorm"]),
            "miou": float(out["miou"]),
            "losses": {k: float(v) for k, v in out["losses"].items()}}


def dp_cases(cfg, sd, cases, trajectory) -> dict:
    """Data-parallel steps over the world. ``cases``: {name: (groups,
    shard_w, clicks)}, each a step from the weights ``sd`` on this rank's
    group (``groups[rank]``, a list of SceneSample) with its click arrays.
    ``trajectory``: (samples, click rows), each step's sample on every rank;
    at each step the one-process step is taken from the same state (the
    model and the optimizer copied), and the run follows the dp result."""
    import copy

    from agile3d_torch.data.datasets import collate_scenes
    from agile3d_torch.engine.train import Optimizer, make_train_step
    from agile3d_torch.parallel.train import make_dp_train_step

    rank = torch.distributed.get_rank()
    mesh = make_mesh(n_dp=torch.distributed.get_world_size(), n_sp=1,
                     device="cpu")
    out = {}
    for name, (groups, shard_w, clicks) in cases.items():
        model, opt = _train_parts(cfg, sd)
        step = make_dp_train_step(cfg, model, opt, mesh)
        batch = collate_scenes(groups[rank], cfg.buckets)
        res = _result(step(*_step_inputs(batch, clicks[rank]),
                           np.asarray(shard_w, np.float32)))
        out[name] = dict(res, state=_state(model))

    samples, rows = trajectory
    model, opt = _train_parts(cfg, sd)
    step = make_dp_train_step(cfg, model, opt, mesh)
    traj = []
    for s, clicks in zip(samples, rows):
        batch = collate_scenes([s], cfg.buckets)
        twin = copy.deepcopy(model)
        twin_opt = Optimizer(twin.named_parameters(), cfg, 1)
        twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        one = _result(make_train_step(cfg, twin, twin_opt)(
            *_step_inputs(batch, clicks)))
        dp = _result(step(*_step_inputs(batch, clicks),
                          np.ones(mesh.shape["dp"], np.float32)))
        traj.append({"one": one, "dp": dp, "one_state": _state(twin),
                     "dp_state": _state(model)})
    out["trajectory"] = traj
    return out


def _world_view() -> list:
    import torch.distributed as dist

    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return [dist.get_rank(), dist.get_world_size(), float(t)]


def torchrun_like(rank: int, port: int, out_dir: str) -> None:
    """A process as ``torchrun`` starts one (RANK, LOCAL_RANK, WORLD_SIZE
    and a localhost rendezvous in its environment) calling ``launch``,
    which must join that group rather than spawn; writes what it saw."""
    import json
    import os

    import torch.distributed as dist

    from agile3d_torch.parallel.mesh import launch

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    got = launch(2, _world_view, device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"view": got, "left_group": not dist.is_initialized()}, f)
