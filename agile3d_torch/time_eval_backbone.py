"""Eval backbone time of the port in a checkout ROOT, on the smoke scene of
``chip_smoke.py`` (400,000 points, 196,608 rows): CUDA events, median of
10 calls after 2 warm-ups, printed as one ``EVAL_AB`` line; then the k5
stem kernel's device time at that scene's level 0 (3 -> 32, seeded x and
w; ``agile3d_torch.tools.time_ms``) as one ``STEM_AB`` line.

    python agile3d_torch/time_eval_backbone.py ROOT

It imports ``agile3d_torch`` from ROOT, so two checkouts (a parent and a
change, each unpacked with ``git archive``) compare on one card: run them
in alternating order, one process each, in one call. Needs a CUDA device.
"""

import os
import statistics
import sys
import tempfile


def main(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.models.agile3d import init_agile3d

    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        scans, lst = write_benchmark(tmp, num_scenes=1, num_obj=8,
                                     n_points=400000, extent=8.0, seed=0)
        batch = collate_scenes([InterMultiObjDataset(scans, lst, 0.05)[0]],
                               cfg.buckets)
    eng = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=0, device="cpu"),
                            "cuda")
    for _ in range(2):
        eng.run_backbone(batch)
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        eng.run_backbone(batch)
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    print("EVAL_AB", os.path.basename(root), statistics.median(ts),
          [round(t, 2) for t in ts], flush=True)

    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.tools import time_ms

    dev = torch.device("cuda")
    k5 = torch.from_numpy(batch.pyramid.levels[0].k5).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((k5.shape[0], 3), generator=g, device=dev)
    w = torch.randn((125, 3, 32), generator=g, device=dev) * 375 ** -0.5
    print("STEM_AB", os.path.basename(root),
          time_ms(lambda: banded_stem_conv(x, k5, w), dev), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
