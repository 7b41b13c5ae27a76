"""The two eval rollouts side by side at the metric level: counterpart of
the repository's ``tools/compare_rollout_paths.py``, on the port.

``evaluate_dataset`` runs each scene's click rounds either on the device
(``engine/device_eval.py``, the default) or in the host loop
(``--host_rollout``, ``engine/eval.py::evaluate_scene``). The port claims
that both write the same rows. This tool measures it where it matters to
a benchmark: over a pool of synthetic scenes (``--groups``, each
``scenes x objects x points``, written by ``write_benchmark`` with seed
100 + its index) it runs both rollouts, and reports each one's
``EvaluatorMO`` results (NoC@{50..90}, IoU@k), their differences, the wall
time of each and, per (scene, object count) trajectory, the first round
whose IoU differs by more than 1e-5 (``first_divergence``). Random
weights are the adversarial case (weak predictions, many near-tied error
clusters); ``--checkpoint`` takes trained ones (a ``checkpoint.pth`` of
``python -m agile3d_torch.main`` or the reference's).

    python -m agile3d_torch.tools.compare_rollout_paths [--out DIR]
        [--groups 12x4x50000,8x7x80000] [--clicks 20] [--seed 42]
        [--checkpoint PTH] [--device cpu]

It runs on the card unless ``--device cpu`` is given. Writes
``DIR/host.csv``, ``DIR/dev.csv`` and ``DIR/summary.json`` (the JAX tool's
keys, plus ``first_divergence``, ``rounds`` (the rounds after round 0 of
every trajectory), each path's kernel ``launches`` and ``device``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.eval import InteractiveEngine, evaluate_dataset
from agile3d_torch.evaluation.evaluators import EvaluatorMO
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.tools import device_label, resolve_device
from agile3d_torch.utils.profiling import kernel_launches

THRESHOLDS = (0.5, 0.65, 0.8, 0.85, 0.9)


def first_divergence(host_csv: str, dev_csv: str, tol: float = 1e-5) -> dict:
    """Per (scene, obj) trajectory: (the first round whose IoU differs by
    more than ``tol``, or None; the host's round count)."""
    def parse(path):
        out = collections.defaultdict(list)
        with open(path) as f:
            for line in f:
                _id, scene, obj, clicks, iou = line.split()
                out[(scene, obj)].append(float(iou))
        return out

    h, d = parse(host_csv), parse(dev_csv)
    firsts = {}
    for key, hs in h.items():
        div = None
        for r, (a, b) in enumerate(zip(hs, d.get(key, []))):
            if abs(a - b) > tol:
                div = r
                break
        firsts[key] = (div, len(hs))
    return firsts


def write_groups(out: str, groups: str):
    """The scene pools of ``groups``: (datasets, the merged val list)."""
    merged, datasets = {}, []
    for gi, spec in enumerate(groups.split(",")):
        n_scenes, num_obj, n_points = map(int, spec.split("x"))
        scans, val_list = write_benchmark(
            os.path.join(out, f"group{gi}"), num_scenes=n_scenes,
            num_obj=num_obj, seed=100 + gi, n_points=n_points)
        with open(val_list) as f:
            merged.update(json.load(f))
        datasets.append(InterMultiObjDataset(scans, val_list, 0.05))
    return datasets, merged


def compare(out: str, *, groups: str, clicks: int, seed: int,
            checkpoint: str | None, device: str, cfg: Config | None = None,
            log=print) -> dict:
    """Both rollouts over the pools; writes and returns the summary.
    ``cfg`` (default: the reference model) sets the model."""
    from agile3d_torch.utils.ckpt import load_checkpoint

    os.makedirs(out, exist_ok=True)
    dev = resolve_device(device or "cuda")
    cfg = cfg or Config()
    model = init_agile3d(cfg.model, seed=0, device="cpu")
    if checkpoint:
        load_checkpoint(checkpoint, model)
    engine = InteractiveEngine(cfg, model, dev)
    datasets, merged = write_groups(out, groups)

    csvs = {"host": os.path.join(out, "host.csv"),
            "dev": os.path.join(out, "dev.csv")}
    times = {"host": 0.0, "dev": 0.0}
    launches = {}
    for name, device_rollout in (("host", False), ("dev", True)):
        parts = []
        before = kernel_launches()
        for gi, ds in enumerate(datasets):
            part = f"{csvs[name]}.g{gi}"
            t0 = time.perf_counter()
            evaluate_dataset(engine, ds, part, max_num_clicks=clicks,
                             seed=seed, device_rollout=device_rollout,
                             log=lambda *a: None)
            times[name] += time.perf_counter() - t0
            with open(part) as f:
                parts.append(f.read())
            log(f"{name} group{gi} done ({times[name]:.1f}s cum)")
        with open(csvs[name], "w") as f:
            f.write("".join(parts))
        launches[name] = {k: v - before[k]
                          for k, v in kernel_launches().items()}

    res = {name: EvaluatorMO(merged, csv, THRESHOLDS).eval_results()
           for name, csv in csvs.items()}
    deltas = {k: res["dev"][k] - res["host"][k] for k in res["host"]}
    log(f"\n{'metric':<10} {'host':>10} {'device':>10} {'delta':>10}")
    for k, d in deltas.items():
        log(f"{k:<10} {res['host'][k]:>10.4f} {res['dev'][k]:>10.4f} "
            f"{d:>+10.4f}")
    log(f"\nwall clock: host {times['host']:.1f}s dev {times['dev']:.1f}s "
        f"({times['host'] / times['dev']:.2f}x)")
    firsts = first_divergence(csvs["host"], csvs["dev"])
    diverged = {k: v for k, v in firsts.items() if v[0] is not None}
    log(f"trajectories diverged: {len(diverged)}/{len(firsts)}")
    for k, (r, total) in sorted(diverged.items()):
        log(f"  {k}: first differing round {r}/{total}")
    summary = {"host": res["host"], "dev": res["dev"], "deltas": deltas,
               "times": times, "n_diverged": len(diverged),
               "n_traj": len(firsts),
               "rounds": sum(n - 1 for _, n in firsts.values()),
               "launches": launches,
               "first_divergence": {f"{s} {o}": r for (s, o), (r, _)
                                    in sorted(firsts.items())},
               "device": device_label(dev), "groups": groups,
               "clicks": clicks, "seed": seed, "checkpoint": checkpoint}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("host loop against device rollout "
                                 "(PyTorch)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rollout_cmp"))
    ap.add_argument("--clicks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--groups", default="12x4x50000,8x7x80000",
                    help="scenes x num_obj x n_points, comma-separated")
    ap.add_argument("--checkpoint", default=None,
                    help="a .pth of weights; default random init (seed 0)")
    ap.add_argument("--device", default="",
                    help="'' or 'cuda' (default): the card; 'cpu'")
    args = ap.parse_args(argv)
    return compare(args.out, groups=args.groups, clicks=args.clicks,
                   seed=args.seed, checkpoint=args.checkpoint,
                   device=args.device)


if __name__ == "__main__":
    main()
