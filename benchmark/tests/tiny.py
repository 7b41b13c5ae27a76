"""Cells of ``BENCHMARK.json`` at a size the CPU runs in seconds: the
published widths, a few thousand points a scene. For the tests only."""

from __future__ import annotations

import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SIZES = {
    "serve": ({"eval": {"points": 6000, "extent": 3.0, "objects": 3,
                        "noise": 0.03}},
              {"clicks_per_session": 6, "warmup_click_counts": [1, 4]}),
    "train": ({"train": {"points": 2000, "extent": 2.5, "objects": 3,
                         "noise": 0.0}},
              {"scenes": 6, "batch_size": 2, "prefetch": 1}),
    "eval": ({"eval": {"points": 5000, "extent": 3.0, "objects": 3,
                       "noise": 0.03}},
             {"pool": 2}),
}


def tiny_cell(name: str):
    from benchmark.harness import cells

    cell = cells.resolve(ROOT, name)
    cfg, tp = dict(cell.config), dict(cell.traffic)
    scenes, traffic = SIZES[tp["kind"]]
    cfg["scenes"] = scenes
    if tp["kind"] == "eval":
        cfg["max_num_clicks"] = 3
    tp.update(traffic)
    return cell._replace(config=cfg, traffic=tp)


def run_tiny(name: str, seed: int, seconds: float, control: str = "",
             trace: bool = False):
    """(result line, checks) of one run on the CPU, past the look for a
    card."""
    from benchmark.harness import runner

    return runner.run(tiny_cell(name), seed=seed, seconds=seconds,
                      trace=trace, device="cpu", t0=time.perf_counter(),
                      control=control)
