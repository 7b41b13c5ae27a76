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

``--device_rollout`` runs each step's click rollout on the device
(``engine/device_train.py``) instead of the host loop; the validation runs
the host loop, as the JAX package's does. ``--num_workers`` batches are
assembled ahead of the step on a host thread (``data/prefetch.py``).

Takes the flags of the JAX package's ``main.py``, the reference model
block among them (``cli.py``), except checkpoints and resume
(``--resume``, ``--start_epoch``, ``--ckpt_epochs``) and data parallelism
(``--num_dp``), which are not ported yet; wandb logging is not ported
either (``--job_name`` is accepted and unused), nor is the single-object
training dataset (``--dataset_mode multi_obj`` only).
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
import time

import numpy as np
import torch

from agile3d_torch.cli import (
    add_reference_model_flags,
    device_arg,
    model_config_from_args,
    not_ported_epilog,
    run,
)
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
    p = argparse.ArgumentParser("AGILE3D training (PyTorch)", add_help=False,
                                epilog=not_ported_epilog("main"))
    p.add_argument("--dataset_mode", default="multi_obj")
    p.add_argument("--scan_folder", default="data/ScanNet/scans", type=str)
    p.add_argument("--train_list", default="data/ScanNet/train_list.json")
    p.add_argument("--val_list", default="data/ScanNet/val_list.json")
    add_reference_model_flags(p)
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
    p.add_argument("--job_name", default="test", type=str,
                   help="accepted for reference scripts; unused (no wandb)")
    p.add_argument("--num_workers", default=2, type=int,
                   help="batches assembled ahead of the step on a host "
                        "thread (the reference's DataLoader workers)")
    p.add_argument("--val_batch_size", default=1, type=int)
    p.add_argument("--device_rollout", action="store_true",
                   help="run the training click rollout on the device "
                        "instead of the per-round host loop")
    return p


def build_config(args) -> Config:
    return Config(
        model=model_config_from_args(args),
        loss=LossConfig(losses=tuple(args.losses),
                        bce_loss_coef=args.bce_loss_coef,
                        dice_loss_coef=args.dice_loss_coef, aux=args.aux),
        train=TrainConfig(
            lr=args.lr, weight_decay=args.weight_decay,
            lr_drop=tuple(args.lr_drop), epochs=args.epochs,
            val_epochs=args.val_epochs, batch_size=args.batch_size,
            val_batch_size=args.val_batch_size,
            clip_max_norm=args.clip_max_norm, seed=args.seed,
            max_num_clicks=args.max_num_clicks,
            num_workers=args.num_workers, prefetch=args.num_workers))


def main(args, log=print) -> dict:
    """Train; returns {"epochs": [per-epoch averages], "val": {epoch:
    evaluator dict}, "model": the trained model}."""
    if args.dataset_mode != "multi_obj":
        raise SystemExit(f"--dataset_mode {args.dataset_mode}: only "
                         "multi_obj training is ported")
    device = resolve_device(device_arg(args))
    cfg = build_config(args)
    seed = args.seed
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)

    model = init_agile3d(cfg.model, seed=seed, device="cpu")
    log(f"number of params: {sum(p.numel() for p in model.parameters())}")
    dataset_train = build_dataset("train", args.dataset_mode,
                                  scan_folder=args.scan_folder,
                                  scene_list=args.train_list,
                                  voxel_size=cfg.model.voxel_size, seed=seed)
    dataset_val = build_dataset("val", args.dataset_mode,
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
                                np_rng=np_rng, py_rng=py_rng, log=log,
                                device_rollout=args.device_rollout)
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
                             seed=seed, log=log, device_rollout=False)
            res = EvaluatorMO(args.val_list, csv).eval_results()
            history["val"][epoch] = res
            log(res)
    log(f"Training time "
        f"{datetime.timedelta(seconds=int(time.time() - start))}")
    return history


if __name__ == "__main__":
    parser = argparse.ArgumentParser("AGILE3D training script",
                                     parents=[get_args_parser()],
                                     epilog=not_ported_epilog("main"))
    run_id = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")

    def main_in_run_dir(args):
        args.output_dir = os.path.join(args.output_dir, run_id)
        return main(args)

    run(parser, main_in_run_dir)
