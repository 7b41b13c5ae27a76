"""Interactive single-object evaluation (the InterObject3D protocol):
``python -m agile3d_torch.eval_single_obj``.

Each (scene, object id) row of the ``--val_list`` npy is one instance: its
labels are binarised, round 0 clicks the object once and every later round
adds one click, up to ``--max_num_clicks`` in all. The rounds after the
first run on the device (``--host_rollout``: the host loop, the same rows).
Writes ``<output_dir>/val_results_single.csv`` with absolute click counts
and prints the evaluator's NoC@tau / IoU@k dict over the objects
(``EvaluatorSO``; ``--val_list_classes`` names each object's class).
Takes every flag of the JAX package's ``eval_single_obj.py``, the
reference model block among them (``cli.py``). ``--checkpoint`` takes a
reference ``.pth``; without one (the default: the released
``checkpoint1099.pth`` is not in the repository) the weights are random,
drawn from ``--seed``. A scene over the card's memory exits with one
``error:`` line.

    python -m agile3d_torch.eval_single_obj --scan_folder SCANS \\
        --val_list OBJECTS.npy [--val_list_classes CLASSES.txt] \\
        [--crop] [--checkpoint ckpt.pth] [--device cpu]
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
    run,
)
from agile3d_torch.config import Config, TrainConfig
from agile3d_torch.data.datasets import build_dataset
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    evaluate_dataset,
    resolve_device,
)
from agile3d_torch.evaluation.evaluators import EvaluatorSO
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.utils.ckpt import load_checkpoint

# the click table holds the 20-click budget with room to spare, as in the
# JAX package's single-object CLI
MAX_CLICKS = 64


def get_args_parser():
    p = argparse.ArgumentParser(
        "Evaluation script for interactive single-object segmentation")
    p.add_argument("--dataset_mode", default="single_obj")
    p.add_argument("--dataset", default="scannet40",
                   choices=["scannet40", "s3dis", "kitti360"])
    p.add_argument("--scan_folder", required=True, type=str)
    p.add_argument("--val_list", required=True, type=str,
                   help="npy file of (scene, object_id) rows")
    p.add_argument("--val_list_classes", default="", type=str,
                   help="txt file of per-object class names")
    p.add_argument("--crop", action="store_true",
                   help="use pre-cropped per-object scans")
    add_reference_model_flags(p)
    p.add_argument("--train_list", default="", type=str,
                   help="accepted for reference scripts; unused by eval")
    p.add_argument("--num_workers", default=2, type=int,
                   help="accepted for reference scripts; eval prepares "
                        "scenes on one host thread, two ahead")
    p.add_argument("--val_batch_size", default=1, type=int,
                   help="must be 1 (one instance per rollout)")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--output_dir", default="results", type=str)
    p.add_argument("--checkpoint", default="", type=str,
                   help="reference .pth; empty (the default, since "
                        "checkpoint1099.pth is not in the repository) = "
                        "random weights from --seed")
    p.add_argument("--max_num_clicks", default=20, type=int)
    p.add_argument("--decoder_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--host_rollout", action="store_true",
                   help="per-round host loop instead of the device rollout")
    return p


def build_config(args) -> Config:
    return Config(model=model_config_from_args(
                      args, max_clicks=MAX_CLICKS,
                      decoder_dtype=args.decoder_dtype),
                  train=TrainConfig(seed=args.seed,
                                    max_num_clicks=args.max_num_clicks))


def main(args, log=print) -> dict:
    check_val_batch_size(args)
    device = resolve_device(device_arg(args))
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    cfg = build_config(args)
    model = init_agile3d(cfg.model, seed=args.seed, device="cpu")
    if args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    engine = InteractiveEngine(cfg, model, device)

    dataset = build_dataset("val", "single_obj", scan_folder=args.scan_folder,
                            scene_list=args.val_list,
                            voxel_size=cfg.model.voxel_size, crop=args.crop)
    os.makedirs(args.output_dir, exist_ok=True)
    results_file = os.path.join(args.output_dir, "val_results_single.csv")
    evaluate_dataset(engine, dataset, results_file,
                     max_num_clicks=args.max_num_clicks, seed=args.seed,
                     log=log, device_rollout=not args.host_rollout,
                     mode="single")
    classes = (np.loadtxt(args.val_list_classes, dtype=str)
               if args.val_list_classes
               else np.array(["unknown"] * len(dataset.items)))
    results = EvaluatorSO(args.dataset, dataset.items, classes,
                          results_file).eval_results()
    log(results)
    return results


if __name__ == "__main__":
    run(get_args_parser(), main)
