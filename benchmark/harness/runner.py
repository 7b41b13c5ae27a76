"""One run of a cell: set-up, the measured window, the device's memory peak,
the comparison with the plain reference, and the result line.

A traffic kind (``benchmark/kinds/<kind>.py``) provides ``setup(ctx)``,
which returns a session with ``window(deadline)`` (returns a ``Window``),
``release()`` (frees the program's state) and ``check(control)`` (the
numbers compared, as (name, value) pairs, after ``release``).
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time
from typing import NamedTuple

import torch

from benchmark.harness import trace as tr


TRACE_SECONDS = 8.0


class StopWindow(Exception):
    """Raised by a kind's wrapper at the first unit that would start past
    the window's end, to leave the program's loop."""


class Context(NamedTuple):
    cell: object
    seed: int
    seconds: float
    device: str
    trace: bool
    tmp: str


class Window(NamedTuple):
    e2e: dict          # end-to-end metric name -> value
    samples: dict      # counts and exact lengths, printed before the checks
    layer: dict        # what the per-layer readers read besides the trace
    attempted: int
    failed: int


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: str = ""):
    """Returns (result line, [(name, value, limit)])."""
    tmp = tempfile.mkdtemp(prefix="agile3d-bench-")
    try:
        return _run(cell, seed, seconds, trace, device, t0, control, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run(cell, seed, seconds, trace, device, t0, control, tmp):
    ctx = Context(cell, seed, seconds, device, trace, tmp)
    session = cell.kind.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t0
    if trace:
        # the profiler's reading of a window costs minutes of host time
        # past some seconds of it: a traced run traces that much, and
        # the unit (click, step, scene) in flight at its end
        seconds = min(seconds, TRACE_SECONDS)
    with tr.traced(trace) as traced:
        start = time.perf_counter()
        win = session.window(start + seconds)
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for k, v in win.samples.items():
        print(f"samples {k} {v!r}", file=sys.stderr)
    if trace:
        own = {n: round(s, 6) for n, s in traced.summary.kernel_s.items()
               if not n.startswith(("void at::", "sm80_", "sm90_", "Memcpy",
                                    "Memset", "void (anonymous"))}
        print(f"samples other_device_ops {own!r}"[:4000], file=sys.stderr)
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = dict(session.check(control))
    # the cell's limits file names the numbers it compares; a kind's other
    # numbers are printed, not judged
    for name, value in values.items():
        if name not in cell.limits:
            print(f"diag {name} {value!r}", file=sys.stderr)
    checks = []
    correct = bool(cell.limits)
    for name, limit in cell.limits.items():
        value = values.get(name)
        ok = (value is not None and math.isfinite(value) and value <= limit)
        correct &= ok
        checks.append((name, value, limit))
    correct &= win.attempted > 0 and win.failed == 0

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not trace:
        have = dict(win.e2e, setup_s=setup_s, peak_gib=peak / 2 ** 30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": have[m["name"]],
                                  "unit": m["unit"]}
    else:
        run_view = type("Run", (), {"trace": traced.summary,
                                    "layer": win.layer, "cell": cell})()
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run_view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(win.attempted),
            "failed": int(win.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.summary.busy_s
        dev["window_s"] = traced.summary.window_s
        line["breakdown"] = tr.breakdown(traced.summary)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line, checks


def scene_dir(ctx: Context, name: str) -> str:
    d = os.path.join(ctx.tmp, name)
    os.makedirs(d, exist_ok=True)
    return d
