"""A longer-horizon training run: counterpart of the repository's
``tools/train_evidence.py``, driving the port's training entry point.

Writes a 72-scene synthetic benchmark (64 train scenes from seed 11, 8
val scenes from seed 999; 6 objects, 60,000 points, ~35,000 voxels a
scene at 5 cm) and runs ``python -m agile3d_torch.main --device_rollout``
for EPOCHS epochs (batch 4, lr 5e-4 dropped at 0.8 x EPOCHS, a 10-click
budget, validation every 10 epochs). The point is the loop at a larger
scale than the CPU tests, with the val metric (NoC / IoU@k through
``EvaluatorMO``) improving, not just the training loss.

    python -m agile3d_torch.tools.train_evidence [WORKDIR] [EPOCHS]
        [--device cpu]

It runs on the card unless ``--device cpu`` is given. Writes
``WORKDIR/summary.json`` as ``train_regime`` does (the JAX tool writes
none; its curve stayed in ``main``'s log).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from agile3d_torch.tools.train_regime import run_pieces, write_data

SCENES, VAL_SCENES, NUM_OBJ, N_POINTS = 64, 8, 6, 60000


def build_command(scans: str, train_list: str, val_list: str, out_dir: str,
                  epochs: int, *, device: str = "") -> list[str]:
    """The JAX tool's ``main`` flags in its order, then ``--device`` where
    given."""
    return ([sys.executable, "-m", "agile3d_torch.main",
             "--scan_folder", scans,
             "--train_list", train_list,
             "--val_list", val_list,
             "--output_dir", out_dir,
             "--epochs", str(epochs),
             "--val_epochs", "10",
             "--batch_size", "4",
             "--lr", "5e-4",
             "--lr_drop", str(int(epochs * 0.8)),
             "--max_num_clicks", "10",
             "--device_rollout",
             "--job_name", "evidence"]
            + (["--device", device] if device else []))


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser("the training evidence run (PyTorch)")
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "train_evidence"))
    ap.add_argument("epochs", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="")
    args = ap.parse_args(argv)
    work = os.path.abspath(args.workdir)
    scans, list_t, list_v = write_data(work, SCENES, VAL_SCENES, N_POINTS,
                                       NUM_OBJ)
    cmd = build_command(scans, list_t, list_v, os.path.join(work, "out"),
                        args.epochs, device=args.device)
    meta = {"epochs": args.epochs, "lr_drop": int(args.epochs * 0.8),
            "scenes": SCENES, "val_scenes": VAL_SCENES,
            "n_points": N_POINTS, "num_obj": NUM_OBJ, "val_epochs": 10}
    return run_pieces(work, cmd, max_seconds=0, resume="", meta=meta,
                      val_list=list_v, device=args.device, log=log)


if __name__ == "__main__":
    main()
