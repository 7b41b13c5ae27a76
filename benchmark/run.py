"""Run one cell of the benchmark once:

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout of the repository. The cell, its configuration,
its traffic mix and its per-layer metrics are found by name from
``BENCHMARK.json``: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the driver
``benchmark/kinds/<kind>.py``), ``benchmark/metrics/<metric>.py`` and
``benchmark/limits/<cell>.json``.

The run makes its scenes and weights from ``--seed``, sets up and warms up
(``setup_s``), measures for ``--seconds``, reads the device's memory peak,
frees the program's state, then holds what the window produced against the
plain reference (``benchmark/reference/``). It prints each number compared
beside its limit as its last lines on standard error, and one JSON object
as the last line of standard output. ``--trace 1`` traces the window with
``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones. Without as many CUDA devices as the cell asks for it exits
with an error and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "agile3d_tpu")


def cache_env(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a cell's first run in a checkout builds; libraries that could
    load JAX by themselves are told not to."""
    cache = os.path.join(root, "benchmark_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: ``agile3d_torch`` is not ``agile3d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    p.add_argument("--control", default="",
                   help="read the comparison's control in place of the "
                        "program's outputs (a measurement of the limits, not "
                        "a run of the benchmark)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    from benchmark.harness import cells

    cell = cells.resolve(ROOT, args.workload)
    import torch

    need = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {need} CUDA device(s); "
              f"torch sees {have}", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    line, checks = runner.run(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda",
                              t0=T0, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
