"""Multi-object iterative-click training: ``python -m agile3d_torch.main``.

Builds the model (random weights from ``--seed``), the train and val
datasets, AdamW with the step schedule, and runs the epoch loop from
``--start_epoch``. Every ``--ckpt_epochs`` epochs, and always after the
last one, it writes the resumable ``<output_dir>/checkpoint.pth``
(``{"model": the reference state-dict layout, "optimizer", "epoch"}``;
``python -m agile3d_torch.eval_multi_obj --checkpoint`` reads its
weights), plus an archival ``checkpoint{epoch:04d}.pth`` every 20 epochs
and before each LR drop, whatever the cadence. ``--resume`` takes such a
checkpoint whole (weights, BatchNorm statistics, optimizer state) and
continues at its epoch + 1; any other ``.pth`` (the reference's
``checkpoint1099.pth``) loads as weights alone, and ``--start_epoch``
stands. The random generators are seeded from ``--seed`` at every start,
as the JAX package's are, so a resumed run does not replay the draws an
uninterrupted one would make. Every ``--val_epochs`` epochs it runs the
interactive validation (the host loop, as the JAX package's does) and
prints the evaluator's metrics and the validation losses. Epoch and
validation numbers go to wandb where the ``wandb`` package and a key are
present (``utils/misc.py::setup_wandb``), else nowhere.

    python -m agile3d_torch.main --scan_folder SCANS --train_list TRAIN.json \\
        --val_list VAL.json [--device cuda] [--epochs N] [--batch_size 5] \\
        [--resume output/RUN/checkpoint.pth] [--ckpt_epochs 1]

``--device_rollout`` runs each step's click rollout on the device
(``engine/device_train.py``) instead of the host loop. ``--num_dp N``
trains data-parallel on N ranks (``parallel/train.py``; ``batch_size x N``
scenes a step, the rollout on the device): the ranks are spawned here
(``nccl``, one card each; ``gloo`` with ``--device cpu``) or are the
caller's group (``torchrun``); rank 0 logs, validates and writes the
checkpoints while the others wait.
``--num_workers`` batches are assembled ahead of the step on a host thread
(``data/prefetch.py``). ``--dataset_mode single_obj`` trains on the
single-object dataset and validates as the JAX package's ``main.py`` does
(the multi-object protocol and evaluator on ``--val_list``).

Takes the flags of the JAX package's ``main.py``, the reference model
block among them (``cli.py``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import time

import numpy as np
import torch
import torch.distributed as dist

from agile3d_torch.cli import (
    add_reference_model_flags,
    device_arg,
    model_config_from_args,
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
from agile3d_torch.parallel.mesh import barrier, launch, make_mesh, rank_device
from agile3d_torch.parallel.train import dp_train_one_epoch, make_dp_train_step
from agile3d_torch.utils.ckpt import load_training_checkpoint, save_checkpoint
from agile3d_torch.utils.misc import MetricLogger, setup_wandb
from agile3d_torch.utils.profiling import kernel_launches


def get_args_parser():
    p = argparse.ArgumentParser("AGILE3D training (PyTorch)", add_help=False)
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
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--resume", default="", help="resume from checkpoint")
    p.add_argument("--max_num_clicks", default=20, type=int)
    p.add_argument("--job_name", default="test", type=str)
    p.add_argument("--num_workers", default=2, type=int,
                   help="batches assembled ahead of the step on a host "
                        "thread (the reference's DataLoader workers)")
    p.add_argument("--val_batch_size", default=1, type=int)
    p.add_argument("--num_dp", default=1, type=int,
                   help="data-parallel ranks (scenes a step = batch_size * "
                        "num_dp)")
    p.add_argument("--device_rollout", action="store_true",
                   help="run the training click rollout on the device "
                        "instead of the per-round host loop")
    p.add_argument("--ckpt_epochs", default=1, type=int,
                   help="rolling-checkpoint cadence: checkpoint.pth every "
                        "N epochs and after the last (1 = the reference's "
                        "per-epoch save); the archival copies every 20 "
                        "epochs and before LR drops are unaffected")
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


def _wandb():
    """wandb where the package and a key are present, else a logger that
    logs nowhere."""
    try:
        import wandb
    except ImportError:
        wandb = None
    if wandb is not None and setup_wandb():
        return wandb
    return _Noop()


class _Noop:
    """A wandb that logs nowhere."""

    def init(self, *a, **k): pass
    def log(self, *a, **k): pass


def main(args, log=print) -> dict:
    """Train; returns {"epochs": [per-epoch averages], "val": {epoch:
    evaluator dict}, "val_losses": {epoch: the validation losses' means},
    "start_epoch": the first epoch run, "model": the trained model,
    "optimizer": its optimizer}, rank 0's (None on the other ranks of a
    caller's group). With ``--num_dp`` > 1 the ranks run ``_train`` (when
    they are spawned here, ``log`` is pickled to them)."""
    if args.ckpt_epochs < 1:
        raise SystemExit(f"--ckpt_epochs must be >= 1, got "
                         f"{args.ckpt_epochs}")
    if args.num_dp < 1:
        raise SystemExit(f"--num_dp must be >= 1, got {args.num_dp}")
    if args.num_dp > 1:
        return launch(args.num_dp, _train, args, log, device=device_arg(args))
    return _train(args, log)


def _train(args, log) -> dict | None:
    num_dp = args.num_dp
    lead = not dist.is_initialized() or dist.get_rank() == 0
    log = log if lead else (lambda *a: None)
    device = resolve_device(rank_device(device_arg(args)))
    wandb = _wandb() if lead else _Noop()
    wandb.init(project="AGILE3D")
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
    steps_per_epoch = max(
        1, len(dataset_train) // (cfg.train.batch_size * num_dp))
    optimizer, _ = make_optimizer(engine.model, cfg, steps_per_epoch)
    if num_dp > 1:
        mesh = make_mesh(n_dp=num_dp, n_sp=1, device=device)
        train_step = make_dp_train_step(cfg, engine.model, optimizer, mesh)
    else:
        train_step = make_train_step(cfg, engine.model, optimizer)

    val_dir = os.path.join(args.output_dir, "valResults")
    if lead:
        os.makedirs(val_dir, exist_ok=True)
    if args.resume:
        epoch = load_training_checkpoint(args.resume, engine.model, optimizer)
        if epoch is not None:
            args.start_epoch = epoch + 1
    history = {"epochs": [], "val": {}, "val_losses": {},
               "start_epoch": args.start_epoch, "model": engine.model,
               "optimizer": optimizer}
    log("Start training")
    start = time.time()
    for epoch in range(args.start_epoch, cfg.train.epochs):
        # the rate the epoch's first step takes (a drop lands at a step
        # count, so the rate can change only between epochs)
        log(f"epoch {epoch} lr {optimizer.lr(optimizer.count):.6g}")
        if num_dp > 1:
            stats = dp_train_one_epoch(cfg, mesh, engine, train_step,
                                       dataset_train, epoch, np_rng=np_rng,
                                       py_rng=py_rng, log=log)
        else:
            stats = train_one_epoch(engine, train_step, dataset_train, cfg,
                                    epoch, np_rng=np_rng, py_rng=py_rng,
                                    log=log,
                                    device_rollout=args.device_rollout)
        history["epochs"].append(stats)
        if not lead:
            # rank 0 checkpoints and validates
            barrier()
            continue
        epoch_log = {"train/epoch": epoch, "train/loss_epoch": stats["loss"]}
        if "mIoU" in stats:
            epoch_log["train/mIoU_epoch"] = stats["mIoU"]
        wandb.log(epoch_log)

        # the rolling checkpoint every --ckpt_epochs and after the last
        # epoch; the archival copies every 20 epochs and before LR drops
        paths = []
        if (epoch + 1) % args.ckpt_epochs == 0 or epoch + 1 == args.epochs:
            paths.append(os.path.join(args.output_dir, "checkpoint.pth"))
        if (epoch + 1) in cfg.train.lr_drop or (epoch + 1) % 20 == 0:
            paths.append(os.path.join(args.output_dir,
                                      f"checkpoint{epoch:04d}.pth"))
        for path in paths:
            save_checkpoint(path, engine.model, epoch, optimizer)

        if (epoch + 1) % cfg.train.val_epochs == 0:
            csv = os.path.join(val_dir, f"val_results_epoch_{epoch}.csv")
            val_meter = MetricLogger()
            # written under another name and renamed when whole, so that a
            # run cut mid-validation leaves no partial CSV
            evaluate_dataset(engine, dataset_val, f"{csv}.tmp",
                             max_num_clicks=cfg.train.max_num_clicks,
                             seed=seed, log=log, device_rollout=False,
                             loss_meter=val_meter)
            os.replace(f"{csv}.tmp", csv)
            res = EvaluatorMO(args.val_list, csv).eval_results()
            history["val"][epoch] = res
            history["val_losses"][epoch] = {
                k: m.global_avg for k, m in val_meter.meters.items()}
            log(f"{res} {val_meter}")
            wandb.log({f"val_metrics/{k.replace('@', '_')}": v
                       for k, v in res.items()})
            wandb.log({f"val/{k}_epoch": v
                       for k, v in history["val_losses"][epoch].items()})
        # this process's steps and kernel launches so far (the launches
        # are rank 0's)
        log(f"epoch {epoch} done: steps {optimizer.count} kernel launches "
            f"{json.dumps(kernel_launches(), sort_keys=True)}")
        barrier()
    log(f"Training time "
        f"{datetime.timedelta(seconds=int(time.time() - start))}")
    return history if lead else None


if __name__ == "__main__":
    parser = argparse.ArgumentParser("AGILE3D training script",
                                     parents=[get_args_parser()])
    run_id = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")

    def main_in_run_dir(args):
        args.output_dir = os.path.join(args.output_dir, run_id)
        return main(args)

    run(parser, main_in_run_dir)
