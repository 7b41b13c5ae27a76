"""The training regime in miniature: counterpart of the repository's
``tools/train_regime.py``, driving the port's training entry point.

It reproduces the shape of the reference's training recipe (reference
main.py:184-207: 1,100 epochs, AdamW at lr 1e-4 dropped x0.1 at epoch
1,000, batch 5, a 20-click budget) cut 10x in epochs (110, the drop at
100) on a synthetic benchmark (``data/synthetic.py::write_benchmark``:
train scenes from seed 11, held-out val scenes from seed 999), running
``python -m agile3d_torch.main --device_rollout`` end to end with periodic
interactive validation. The point is evidence that the recipe learns over
a long run (the LR drop, click sampling across epochs, NoC / IoU@k
validation, checkpointing), not that one step descends.

    python -m agile3d_torch.tools.train_regime [WORKDIR] [--epochs 110]
        [--scenes 200] [--val_scenes 20] [--n_points 30000] [--num_obj 6]
        [--val_epochs 10] [--max_seconds S] [--resume CKPT]
        [--seed N] [--device cpu] [-- MAIN_FLAGS...]

It runs on the card unless ``--device cpu`` is given. ``--max_seconds``
bounds the wall clock: ``main`` gets TERM (then KILL) at that budget, and
every epoch that finished is still read. The per-epoch checkpoint makes a
cut run resumable: ``--resume WORKDIR/out/<run>/checkpoint.pth`` continues
at its epoch + 1 (``last_checkpoint`` finds the newest). ``main`` writes
the checkpoint before it validates (and a val CSV only when the
validation is whole), so a cut can fall between the two: that epoch's
validation is then lost, and the summary lists it under
``lost_validations``. Flags after ``--`` go to ``main`` as they are (a
reduced width, a click budget).

The val scans are linked into the train scan folder only where no train
scan has their name (as the JAX tool does): where the val scenes' names
are among the train scenes' (10 val scenes beside 25 train scenes), the
validation runs on those train scenes, without augmentation.

Writes ``WORKDIR/summary.json``: the JAX tool's keys (``exit``, ``wall_s``,
``epochs``, ``lr_drop``, ``scenes``, ``val_scenes``, ``n_points``,
``val_curves``: per validated epoch, ``EvaluatorMO``'s NoC@{50..90} and
IoU@{1,3,5,10,15}), plus ``val_epochs``, ``device`` (the card's name and
power limit from ``nvidia-smi``), ``steps`` (the optimizer's update count
at the end), ``lr_by_epoch``, ``launches`` (each kernel's launches, summed over the
pieces), ``lost_validations`` and ``pieces``: one entry per invocation (a
resumed run appends to the summary it finds), with ``in_pieces`` true when
there is more than one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.evaluation.evaluators import EvaluatorMO
from agile3d_torch.tools import device_label, resolve_device

THRESHOLDS = (0.5, 0.65, 0.8, 0.85, 0.9)
TRAIN_SEED, VAL_SEED = 11, 999
# the directory that holds the agile3d_torch package: the child's path
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_LR = re.compile(r"^epoch (\d+) lr (\S+)$")
_DONE = re.compile(r"^epoch (\d+) done: steps (\d+) kernel launches (\{.*\})$")
_CSV = re.compile(r"val_results_epoch_(\d+)\.csv$")


def write_data(work: str, scenes: int, val_scenes: int, n_points: int,
               num_obj: int) -> tuple[str, str, str]:
    """The train and val benchmarks under ``work`` (seeds 11 and 999), the
    val scans linked into the train scan folder by absolute path (a
    relative target would resolve against the link's own folder). Returns
    (scan folder, train list, val list)."""
    os.makedirs(work, exist_ok=True)
    scans_t, list_t = write_benchmark(os.path.join(work, "train"),
                                      num_scenes=scenes, num_obj=num_obj,
                                      seed=TRAIN_SEED, n_points=n_points)
    scans_v, list_v = write_benchmark(os.path.join(work, "val"),
                                      num_scenes=val_scenes, num_obj=num_obj,
                                      seed=VAL_SEED, n_points=n_points)
    for f in os.listdir(scans_v):
        dst = os.path.join(scans_t, f)
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(os.path.join(scans_v, f)), dst)
    return scans_t, list_t, list_v


def lr_drop_epoch(epochs: int, frac: float) -> int:
    return max(1, int(round(epochs * frac)))


def build_command(scans: str, train_list: str, val_list: str, out_dir: str,
                  *, epochs: int, lr_drop: int, val_epochs: int,
                  resume: str = "", seed: int | None = None,
                  device: str = "", extra=()) -> list[str]:
    """The regime's ``main`` command: the JAX tool's flags in its order
    (the reference regime's lr 1e-4, batch 5, 20-click budget, the device
    rollout), then ``--resume``, ``--seed``, ``--device`` where given and
    ``extra``."""
    return ([sys.executable, "-m", "agile3d_torch.main",
             "--scan_folder", scans,
             "--train_list", train_list,
             "--val_list", val_list,
             "--output_dir", out_dir,
             "--epochs", str(epochs),
             "--lr_drop", str(lr_drop),
             "--val_epochs", str(val_epochs),
             "--batch_size", "5",
             "--lr", "1e-4",
             "--max_num_clicks", "20",
             "--device_rollout",
             "--job_name", "regime"]
            + (["--resume", resume] if resume else [])
            + (["--seed", str(seed)] if seed is not None else [])
            + (["--device", device] if device else []) + list(extra))


def run_bounded(cmd: list[str], log_path: str, max_seconds: float,
                log=print, stop_after_epoch: int | None = None
                ) -> tuple[int, float, bool]:
    """Run ``cmd`` with its output appended to ``log_path`` (unbuffered, so
    a cut run still shows its progress) and the package on its path; TERM
    at ``max_seconds`` (0: no bound), or once the log shows ``main``'s
    ``epoch N done`` line for ``stop_after_epoch`` (None: never), and KILL
    a minute later. Returns (exit code, wall seconds, whether it was
    cut)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [PACKAGE_PARENT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.time()
    start = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    with open(log_path, "a") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
        rc = _wait(proc, t0 + max_seconds if max_seconds else None,
                   log_path, start, stop_after_epoch)
        cut = rc is None
        if cut:
            why = (f"wall-clock budget ({max_seconds:.0f}s) reached"
                   if max_seconds and time.time() - t0 >= max_seconds
                   else f"epoch {stop_after_epoch} done")
            log(f"{why}; terminating main (per-epoch checkpoints make "
                "this resumable)")
            proc.terminate()
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
    return rc, time.time() - t0, cut


def _wait(proc, deadline: float | None, log_path: str, start: int,
          stop_after_epoch: int | None) -> int | None:
    """``proc``'s exit code, or None at ``deadline`` or once the log past
    ``start`` holds the ``epoch N done`` line of ``stop_after_epoch``."""
    while deadline is None or time.time() < deadline:
        try:
            return proc.wait(timeout=0.2)
        except subprocess.TimeoutExpired:
            pass
        if stop_after_epoch is not None:
            with open(log_path) as f:
                f.seek(start)
                done = read_progress(f.read().splitlines())["epochs_done"]
            if stop_after_epoch in done:
                return None
    return None


def read_curves(out_dir: str, val_list: str) -> dict:
    """``EvaluatorMO`` at ``THRESHOLDS`` on every validation CSV that
    ``main`` wrote under ``out_dir/<run>/valResults`` (``main`` puts each
    run in a timestamped folder, so every piece of a resumed run counts),
    by epoch."""
    curves = {}
    runs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    for run_dir in runs:
        val_dir = os.path.join(out_dir, run_dir, "valResults")
        if not os.path.isdir(val_dir):
            continue
        for f in sorted(os.listdir(val_dir)):
            m = _CSV.match(f)
            if not m:
                continue
            res = EvaluatorMO(val_list, os.path.join(val_dir, f),
                              THRESHOLDS).eval_results()
            curves[int(m.group(1))] = {k: float(v) for k, v in res.items()}
    return curves


def read_progress(lines) -> dict:
    """From one piece's log lines of ``main``: the LR of each epoch it
    began, the epochs it finished, the optimizer's count and the kernels'
    launches at the last finished one (the process's counts so far)."""
    lr, done, steps, launches = {}, [], None, {}
    for line in lines:
        line = line.strip()
        if m := _LR.match(line):
            lr[int(m.group(1))] = float(m.group(2))
        elif m := _DONE.match(line):
            done.append(int(m.group(1)))
            steps, launches = int(m.group(2)), json.loads(m.group(3))
    return {"lr_by_epoch": lr, "epochs_done": done, "steps": steps,
            "launches": launches}


def last_checkpoint(work: str) -> str | None:
    """The newest rolling checkpoint under ``work/out``, or None."""
    paths = glob.glob(os.path.join(work, "out", "*", "checkpoint.pth"))
    return max(paths, key=os.path.getmtime) if paths else None


def resume_state(resume: str) -> dict:
    """The epoch a checkpoint was written after and the optimizer's update
    count in it (None where it holds none)."""
    import torch

    ckpt = torch.load(resume, map_location="cpu", weights_only=False)
    return {"epoch": ckpt.get("epoch"),
            "steps": ckpt.get("optimizer", {}).get("count")}


def _device_line(device: str) -> str:
    dev = resolve_device(device or "cuda")
    return device_label(dev) if dev.type == "cuda" else "cpu"


def run_pieces(work: str, cmd: list[str], *, max_seconds: float,
               resume: str, meta: dict, val_list: str,
               device: str, log=print,
               stop_after_epoch: int | None = None) -> dict:
    """Run ``cmd`` (one piece; ``run_bounded`` cuts it), then write and
    return ``work/summary.json`` with ``meta``'s keys, the curves of every
    finished validation, the validations that a cut lost (due every
    ``meta["val_epochs"]`` at or before a resumed checkpoint's epoch, with
    no CSV) and the pieces so far (a resumed run appends to the summary it
    finds)."""
    device_line = _device_line(device)
    path = os.path.join(work, "summary.json")
    pieces = []
    if resume and os.path.exists(path):
        with open(path) as f:
            pieces = json.load(f).get("pieces", [])
        for p in pieces:   # JSON gave the epochs as strings
            p["lr_by_epoch"] = {int(e): v for e, v in p["lr_by_epoch"].items()}
    resumed = resume_state(resume) if resume else None
    log_path = os.path.join(work, "train_log.txt")
    marker = f"=== piece {len(pieces)}: {' '.join(cmd)}"
    with open(log_path, "a") as f:
        f.write(marker + "\n")
    log(f"{meta} | running: {' '.join(cmd)}")
    rc, wall, cut = run_bounded(cmd, log_path, max_seconds, log=log,
                                stop_after_epoch=stop_after_epoch)
    log(f"main exit: {rc} after {wall:.0f}s")
    with open(log_path) as f:
        text = f.read()
    progress = read_progress(text[text.rindex(marker):].splitlines())
    pieces.append({"exit": rc, "wall_s": wall, "cut": cut,
                   "resume": resume, "resumed_from": resumed,
                   "device": device_line, **progress})
    launches = {}
    for p in pieces:
        for k, v in p["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the count at the last finished epoch; a resumed piece that finished
    # none stands at its checkpoint's
    counts = (p["steps"] if p["steps"] is not None
              else (p.get("resumed_from") or {}).get("steps")
              for p in reversed(pieces))
    steps = next((c for c in counts if c is not None), 0)
    curves = read_curves(os.path.join(work, "out"), val_list)
    resumed_at = max((e for p in pieces
                      if (e := (p["resumed_from"] or {}).get("epoch"))
                      is not None), default=-1)
    every = meta.get("val_epochs")
    lost = [e for e in range(resumed_at + 1)
            if every and (e + 1) % every == 0 and e not in curves]
    summary = {**meta, "exit": rc, "wall_s": sum(p["wall_s"] for p in pieces),
               "device": device_line, "steps": steps,
               "lr_by_epoch": {e: lr for p in pieces
                               for e, lr in p["lr_by_epoch"].items()},
               "launches": launches, "pieces": pieces,
               "in_pieces": len(pieces) > 1,
               "lost_validations": lost, "val_curves": curves}
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    log(json.dumps(summary, sort_keys=True))
    return summary


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("the training regime (PyTorch)")
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "train_regime"))
    ap.add_argument("--epochs", type=int, default=110)
    ap.add_argument("--lr_drop_frac", type=float, default=1000 / 1100,
                    help="the reference drops the lr at epoch 1000/1100")
    ap.add_argument("--scenes", type=int, default=200)
    ap.add_argument("--val_scenes", type=int, default=20)
    ap.add_argument("--n_points", type=int, default=30000)
    ap.add_argument("--num_obj", type=int, default=6)
    ap.add_argument("--val_epochs", type=int, default=10)
    ap.add_argument("--resume", default="",
                    help="resume a cut run from this checkpoint.pth")
    ap.add_argument("--max_seconds", type=float, default=0,
                    help="wall-clock bound: TERM (then KILL) main at this "
                         "budget and read whatever epochs finished")
    ap.add_argument("--seed", type=int, default=None,
                    help="main's --seed (its default, 42, when not given)")
    ap.add_argument("--device", default="",
                    help="'' or 'cuda' (default): the card; 'cpu'")
    return ap


def split_argv(argv):
    """(the tool's arguments, ``main``'s after ``--``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:]
    return argv, []


def main(argv=None, log=print, stop_after_epoch: int | None = None) -> dict:
    """The tool; ``stop_after_epoch`` cuts the piece once that epoch is
    done (a cut at a known point, for a check of ``--resume``)."""
    own, extra = split_argv(argv)
    args = get_args_parser().parse_args(own)
    work = os.path.abspath(args.workdir)
    scans, list_t, list_v = write_data(work, args.scenes, args.val_scenes,
                                       args.n_points, args.num_obj)
    lr_drop = lr_drop_epoch(args.epochs, args.lr_drop_frac)
    cmd = build_command(scans, list_t, list_v, os.path.join(work, "out"),
                        epochs=args.epochs, lr_drop=lr_drop,
                        val_epochs=args.val_epochs, resume=args.resume,
                        seed=args.seed, device=args.device, extra=extra)
    meta = {"epochs": args.epochs, "lr_drop": lr_drop,
            "scenes": args.scenes, "val_scenes": args.val_scenes,
            "n_points": args.n_points, "num_obj": args.num_obj,
            "val_epochs": args.val_epochs, "seed": args.seed}
    return run_pieces(work, cmd, max_seconds=args.max_seconds,
                      resume=args.resume, meta=meta, val_list=list_v,
                      device=args.device, log=log,
                      stop_after_epoch=stop_after_epoch)


if __name__ == "__main__":
    main()
