"""Interactive multi-object evaluation: ``python -m agile3d_torch.eval_multi_obj``.

Runs the clicks-per-object rollout over the validation list, its rounds
after the first on the device (``--host_rollout``: the host loop, the
same rows), writes ``<output_dir>/val_results_multi.csv`` and prints the
evaluator's NoC@tau / IoU@k dict. Takes the flags of the JAX package's
``eval_multi_obj.py``, the reference model block among them (``cli.py``),
except the parallel ones (``--sp``, ``--sp_backbone``,
``--scene_parallel``), which are not ported yet. ``--checkpoint`` takes a
reference ``.pth``; without one (the default: the released
``checkpoint1099.pth`` is not in the repository) the weights are random,
drawn from ``--seed``. A scene over the card's memory exits with one
``error:`` line.

    python -m agile3d_torch.eval_multi_obj --scan_folder SCANS \\
        --val_list VAL.json [--checkpoint ckpt.pth] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from agile3d_torch.cli import (
    add_reference_model_flags,
    check_val_batch_size,
    device_arg,
    model_config_from_args,
    not_ported_epilog,
    run,
)
from agile3d_torch.config import Config, TrainConfig
from agile3d_torch.data.datasets import build_dataset
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    evaluate_dataset,
    resolve_device,
)
from agile3d_torch.evaluation.evaluators import EvaluatorMO
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.utils.ckpt import load_checkpoint


def get_args_parser():
    p = argparse.ArgumentParser(
        "Evaluation script for interactive multi-object segmentation",
        epilog=not_ported_epilog("eval_multi_obj"))
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
    p.add_argument("--decoder_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    return p


def main(args, log=print) -> dict:
    check_val_batch_size(args)
    device = resolve_device(device_arg(args))
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
    engine = InteractiveEngine(cfg, model, device)

    dataset = build_dataset("val", "multi_obj", scan_folder=args.scan_folder,
                            scene_list=args.val_list,
                            voxel_size=cfg.model.voxel_size)
    os.makedirs(args.output_dir, exist_ok=True)
    results_file = os.path.join(args.output_dir, "val_results_multi.csv")
    evaluate_dataset(engine, dataset, results_file,
                     max_num_clicks=args.max_num_clicks, seed=args.seed,
                     log=log, device_rollout=not args.host_rollout)
    results = EvaluatorMO(args.val_list, results_file).eval_results()
    log(results)
    return results


if __name__ == "__main__":
    run(get_args_parser(), main)
