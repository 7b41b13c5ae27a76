"""Multi-object iterative-click training: ``python -m agile3d_torch.main``.

Builds the model (random weights from ``--seed``), the train and val
datasets, AdamW with the step schedule, and runs the epoch loop. After
every epoch it writes ``<output_dir>/checkpoint.pth`` in the reference
state-dict layout (``python -m agile3d_torch.eval_multi_obj --checkpoint``
reads it), plus an archival ``checkpoint{epoch:04d}.pth`` every 20 epochs
and before each LR drop; every ``--val_epochs`` epochs it runs the
interactive validation and prints the evaluator's metrics.

    python -m agile3d_torch.main --scan_folder SCANS --train_list TRAIN.json \\
        --val_list VAL.json [--device cuda] [--epochs N] [--batch_size 5]

Not in this CLI yet: ``--resume`` (no optimizer checkpoints), data
parallelism, the on-device rollout and wandb logging.
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
import time

import numpy as np
import torch

from agile3d_torch.config import Config, LossConfig, TrainConfig
from agile3d_torch.data.datasets import build_dataset
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    evaluate_dataset,
    resolve_device,
)
from agile3d_torch.engine.train import (
    make_optimizer,
    make_train_step,
    train_one_epoch,
)
from agile3d_torch.evaluation.evaluators import EvaluatorMO
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.utils.ckpt import save_checkpoint


def get_args_parser():
    p = argparse.ArgumentParser("AGILE3D training (PyTorch)", add_help=False)
    p.add_argument("--scan_folder", default="data/ScanNet/scans", type=str)
    p.add_argument("--train_list", default="data/ScanNet/train_list.json")
    p.add_argument("--val_list", default="data/ScanNet/val_list.json")
    p.add_argument("--losses", default=["bce", "dice"], nargs="+",
                   choices=["bce", "dice"])
    p.add_argument("--bce_loss_coef", default=1.0, type=float)
    p.add_argument("--dice_loss_coef", default=2.0, type=float)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--lr_drop", default=[1000], type=int, nargs="+")
    p.add_argument("--epochs", default=1100, type=int)
    p.add_argument("--val_epochs", default=50, type=int)
    p.add_argument("--batch_size", default=5, type=int)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--max_num_clicks", default=20, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def build_config(args) -> Config:
    return Config(
        loss=LossConfig(losses=tuple(args.losses),
                        bce_loss_coef=args.bce_loss_coef,
                        dice_loss_coef=args.dice_loss_coef),
        train=TrainConfig(
            lr=args.lr, weight_decay=args.weight_decay,
            lr_drop=tuple(args.lr_drop), epochs=args.epochs,
            val_epochs=args.val_epochs, batch_size=args.batch_size,
            clip_max_norm=args.clip_max_norm, seed=args.seed,
            max_num_clicks=args.max_num_clicks))


def main(args, log=print) -> dict:
    """Train; returns {"epochs": [per-epoch averages], "val": {epoch:
    evaluator dict}, "model": the trained model}."""
    device = resolve_device(args.device)
    cfg = build_config(args)
    seed = args.seed
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)

    model = init_agile3d(cfg.model, seed=seed, device="cpu")
    log(f"number of params: {sum(p.numel() for p in model.parameters())}")
    dataset_train = build_dataset("train", "multi_obj",
                                  scan_folder=args.scan_folder,
                                  scene_list=args.train_list,
                                  voxel_size=cfg.model.voxel_size, seed=seed)
    dataset_val = build_dataset("val", "multi_obj",
                                scan_folder=args.scan_folder,
                                scene_list=args.val_list,
                                voxel_size=cfg.model.voxel_size)

    engine = InteractiveEngine(cfg, model, device)
    steps_per_epoch = max(1, len(dataset_train) // cfg.train.batch_size)
    optimizer, _ = make_optimizer(engine.model, cfg, steps_per_epoch)
    train_step = make_train_step(cfg, engine.model, optimizer)

    val_dir = os.path.join(args.output_dir, "valResults")
    os.makedirs(val_dir, exist_ok=True)
    history = {"epochs": [], "val": {}, "model": engine.model}
    log("Start training")
    start = time.time()
    for epoch in range(cfg.train.epochs):
        stats = train_one_epoch(engine, train_step, dataset_train, cfg, epoch,
                                np_rng=np_rng, py_rng=py_rng, log=log)
        history["epochs"].append(stats)

        paths = [os.path.join(args.output_dir, "checkpoint.pth")]
        if (epoch + 1) in cfg.train.lr_drop or (epoch + 1) % 20 == 0:
            paths.append(os.path.join(args.output_dir,
                                      f"checkpoint{epoch:04d}.pth"))
        for path in paths:
            save_checkpoint(path, engine.model, epoch)

        if (epoch + 1) % cfg.train.val_epochs == 0:
            csv = os.path.join(val_dir, f"val_results_epoch_{epoch}.csv")
            evaluate_dataset(engine, dataset_val, csv,
                             max_num_clicks=cfg.train.max_num_clicks,
                             seed=seed, log=log)
            res = EvaluatorMO(args.val_list, csv).eval_results()
            history["val"][epoch] = res
            log(res)
    log(f"Training time "
        f"{datetime.timedelta(seconds=int(time.time() - start))}")
    return history


if __name__ == "__main__":
    parser = argparse.ArgumentParser("AGILE3D training script",
                                     parents=[get_args_parser()])
    args = parser.parse_args()
    run_id = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    args.output_dir = os.path.join(args.output_dir, run_id)
    main(args)
