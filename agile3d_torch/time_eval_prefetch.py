"""Eval's scene prefetch (``data/prefetch.py``) at depth 2 against depth 0,
on the single-object entry point: the smoke scene of ``chip_smoke.py``
(400,000 points), its first 3 objects at 20 clicks each, device rollout.
One warm-up run, then 8 runs in the order 0, 2, 2, 0, 0, 2, 2, 0, each a
JSON line (wall s, each object's backbone ms and the device rounds' ms by
CUDA events, through ``chip_smoke._single_run``), then one ``AB`` line
per depth with the medians.

    python agile3d_torch/time_eval_prefetch.py

Run it from the repository's root (it imports ``chip_smoke``). Needs a
CUDA device.
"""

import json
import os
import statistics
import sys
import tempfile

ORDER = (0, 2, 2, 0, 0, 2, 2, 0)


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from agile3d_torch.data.prefetch import BatchPrefetcher
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.engine import eval as peval

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {0: [], 2: []}
    with tempfile.TemporaryDirectory() as tmp:
        scans, _ = write_benchmark(os.path.join(tmp, "smoke"),
                                   **cs.SMOKE_SCENE)
        objects = os.path.join(tmp, "objects.npy")
        np.save(objects, np.array([["scene0000_00", str(o)]
                                   for o in (1, 2, 3)]))
        cs._single_run(torch, scans, objects, os.path.join(tmp, "warm"),
                       False)
        for i, depth in enumerate(ORDER):
            # evaluate_dataset's prefetcher, at this run's depth
            peval.BatchPrefetcher = (lambda fn, items, depth, d=depth:
                                     BatchPrefetcher(fn, items, depth=d))
            r = cs._single_run(torch, scans, objects,
                               os.path.join(tmp, f"r{i}"), False)
            row = dict(depth=depth, wall_s=r["wall_s"],
                       backbone_ms=r["backbone_ms"], rounds_ms=r["rounds_ms"],
                       ms_per_round=r["rounds_ms"] / (len(r["rows"]) - 3))
            out[depth].append(row)
            print(json.dumps(row), flush=True)
    for d in (0, 2):
        print("AB depth", d, "wall median",
              statistics.median(x["wall_s"] for x in out[d]),
              "ms/round median",
              statistics.median(x["ms_per_round"] for x in out[d]),
              "backbone median",
              statistics.median(v for x in out[d] for v in x["backbone_ms"]),
              flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
