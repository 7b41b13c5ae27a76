"""Interactive multi-object evaluation: ``python -m agile3d_torch.eval_multi_obj``.

Runs the clicks-per-object rollout over the validation list, its rounds
after the first on the device (``--host_rollout``: the host loop, the
same rows), writes ``<output_dir>/val_results_multi.csv`` and prints the
evaluator's NoC@tau / IoU@k dict. Takes the flags of the JAX package's
``eval_multi_obj.py``, the reference model block among them (``cli.py``).
``--checkpoint`` takes a reference ``.pth``; without one (the default: the
released ``checkpoint1099.pth`` is not in the repository) the weights are
random, drawn from ``--seed``. A scene over the card's memory exits with
one ``error:`` line.

``--sp N`` shards the decoder's voxel axis over N ranks
(``parallel/sp.py``, ``parallel/sp_rollout.py``), ``--sp_backbone`` the
backbone's too (``parallel/sp_backbone.py``): the ranks are spawned here
(``nccl``, one card each; ``gloo`` with ``--device cpu``), or are the
caller's group (``torchrun``); rank 0 writes the CSV and prints.
``--scene_parallel N`` evaluates scenes on N devices at once, one thread
each (``engine/eval.py::evaluate_dataset_parallel``; the first N cards, or
N CPU workers with ``--device cpu``).

    python -m agile3d_torch.eval_multi_obj --scan_folder SCANS \\
        --val_list VAL.json [--checkpoint ckpt.pth] [--device cpu] [--sp 2]
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch
import torch.distributed as dist

from agile3d_torch.cli import (
    add_reference_model_flags,
    check_val_batch_size,
    device_arg,
    model_config_from_args,
    run,
)
from agile3d_torch.config import Config, TrainConfig
from agile3d_torch.data.datasets import build_dataset
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    evaluate_dataset,
    evaluate_dataset_parallel,
    resolve_device,
)
from agile3d_torch.evaluation.evaluators import EvaluatorMO
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.parallel.mesh import barrier, launch, rank_device
from agile3d_torch.utils.ckpt import load_checkpoint


def get_args_parser():
    p = argparse.ArgumentParser(
        "Evaluation script for interactive multi-object segmentation")
    p.add_argument("--dataset_mode", default="multi_obj")
    p.add_argument("--scan_folder", required=True, type=str)
    p.add_argument("--val_list", required=True, type=str)
    add_reference_model_flags(p)
    p.add_argument("--train_list", default="", type=str,
                   help="accepted for reference scripts; unused by eval")
    p.add_argument("--num_workers", default=2, type=int,
                   help="accepted for reference scripts; eval prepares "
                        "scenes on one host thread, two ahead")
    p.add_argument("--val_batch_size", default=1, type=int,
                   help="must be 1 (one scene per rollout)")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--output_dir", default="results", type=str)
    p.add_argument("--checkpoint", default="", type=str,
                   help="reference .pth; empty (the default, since "
                        "checkpoint1099.pth is not in the repository) = "
                        "random weights from --seed")
    p.add_argument("--max_num_clicks", default=20, type=int)
    p.add_argument("--max_clicks_budget", default=256, type=int,
                   help="click-table capacity (ModelConfig.max_clicks)")
    p.add_argument("--host_rollout", action="store_true",
                   help="per-round host loop instead of the device rollout")
    p.add_argument("--device_rollout", action="store_true",
                   help=argparse.SUPPRESS)  # the default, as in JAX's CLI
    p.add_argument("--sp", default=1, type=int,
                   help="shard the decoder's voxel axis over this many "
                        "ranks (1 = one process)")
    p.add_argument("--sp_backbone", action="store_true",
                   help="with --sp > 1: also shard the backbone's voxel "
                        "axis (the halo-exchange UNet)")
    p.add_argument("--scene_parallel", default=0, type=int,
                   help="evaluate scenes in parallel on this many devices "
                        "(per-scene seeding keeps the rows independent of "
                        "the device count)")
    p.add_argument("--decoder_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    return p


def main(args, log=print) -> dict | None:
    """Evaluate; returns the evaluator's dict (None on the ranks but 0 of
    a caller's group). With ``--sp`` > 1 the ranks run ``_evaluate`` (when
    they are spawned here, ``log`` is pickled to them)."""
    check_val_batch_size(args)
    if args.sp > 1 and args.scene_parallel <= 1:
        return launch(args.sp, _evaluate, args, log, device=device_arg(args))
    return _evaluate(args, log)


def _evaluate(args, log) -> dict | None:
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = log if lead else (lambda *a: None)
    device = resolve_device(rank_device(device_arg(args)))
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    cfg = Config(model=model_config_from_args(
                     args, max_clicks=args.max_clicks_budget,
                     decoder_dtype=args.decoder_dtype),
                 train=TrainConfig(seed=args.seed,
                                   max_num_clicks=args.max_num_clicks))
    model = init_agile3d(cfg.model, seed=args.seed, device="cpu")
    if args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    dataset = build_dataset("val", "multi_obj", scan_folder=args.scan_folder,
                            scene_list=args.val_list,
                            voxel_size=cfg.model.voxel_size)
    os.makedirs(args.output_dir, exist_ok=True)
    results_file = os.path.join(args.output_dir, "val_results_multi.csv")
    if args.scene_parallel > 1:
        n = args.scene_parallel
        devices = ([device] * n if device.type == "cpu" else
                   [torch.device("cuda", i)
                    for i in range(min(n, torch.cuda.device_count()))])
        evaluate_dataset_parallel(cfg, model, dataset, results_file,
                                  devices=devices,
                                  max_num_clicks=args.max_num_clicks,
                                  seed=args.seed, log=say)
    else:
        engine = InteractiveEngine(cfg, model, device, sp=args.sp,
                                   sp_backbone=args.sp_backbone)
        # every sp rank computes the same rows; rank 0 writes them
        evaluate_dataset(engine, dataset,
                         results_file if lead else os.devnull,
                         max_num_clicks=args.max_num_clicks, seed=args.seed,
                         log=say, device_rollout=not args.host_rollout)
        barrier()
    if not lead:
        return None
    results = EvaluatorMO(args.val_list, results_file).eval_results()
    log(results)
    return results


if __name__ == "__main__":
    run(get_args_parser(), main)
