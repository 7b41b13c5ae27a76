"""Interactive multi-object evaluation: ``python -m agile3d_torch.eval_multi_obj``.

Runs the clicks-per-object rollout over the validation list, its rounds
after the first on the device (``--host_rollout``: the host loop, the
same rows), writes ``<output_dir>/val_results_multi.csv`` and prints the
evaluator's NoC@tau / IoU@k dict. ``--checkpoint`` takes a reference
``.pth``; without one the weights are random, drawn from ``--seed``.

    python -m agile3d_torch.eval_multi_obj --scan_folder SCANS \\
        --val_list VAL.json [--checkpoint ckpt.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset
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
        "Evaluation script for interactive multi-object segmentation")
    p.add_argument("--scan_folder", required=True, type=str)
    p.add_argument("--val_list", required=True, type=str)
    p.add_argument("--checkpoint", default="", type=str,
                   help="reference .pth; empty = random weights from --seed")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--max_num_clicks", default=20, type=int)
    p.add_argument("--output_dir", default="results", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    p.add_argument("--host_rollout", action="store_true",
                   help="per-round host loop instead of the device rollout")
    return p


def main(args, log=print) -> dict:
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    cfg = Config()
    model = init_agile3d(cfg.model, seed=args.seed, device="cpu")
    if args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    engine = InteractiveEngine(cfg, model, device)

    dataset = InterMultiObjDataset(args.scan_folder, args.val_list,
                                   cfg.model.voxel_size)
    os.makedirs(args.output_dir, exist_ok=True)
    results_file = os.path.join(args.output_dir, "val_results_multi.csv")
    evaluate_dataset(engine, dataset, results_file,
                     max_num_clicks=args.max_num_clicks, seed=args.seed,
                     log=log, device_rollout=not args.host_rollout)
    results = EvaluatorMO(args.val_list, results_file).eval_results()
    log(results)
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
