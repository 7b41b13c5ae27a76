"""The traced window: device time by kernel name, the device's busy time
(the union of every device operation's interval), and the idle gaps by
what the benchmark's own spans say the host was doing."""

from __future__ import annotations

import bisect
import contextlib
from typing import NamedTuple

import torch

WINDOW = "benchmark.window"


class TraceSummary(NamedTuple):
    busy_s: float             # union of device operations in the window
    window_s: float           # the window's length on the trace's clock
    kernel_s: dict            # device seconds by operation name
    kernel_n: dict            # launches by operation name
    gaps: dict                # idle seconds by the host span around them
    span_device_s: dict       # device seconds of the operations that
                              # started inside each kind of span
    span_n: dict              # spans of each kind in the window


def span(name: str):
    """A span of the benchmark around a call into the program; shows on
    the profiler's timeline (a no-op cost when nothing traces). Spans do
    not nest."""
    return torch.profiler.record_function("benchmark." + name)


@contextlib.contextmanager
def traced(on: bool):
    """Yields a holder whose ``summary`` is set after the block."""
    holder = type("Traced", (), {"summary": None})()
    if not on:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.summary = summarize(prof.events())


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> TraceSummary:
    window = None
    dev, spans = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the benchmark's spans show on the device's timeline too
            if not ev.name.startswith("benchmark."):
                dev.append((tr.start, tr.end, ev.name))
        elif ev.name == WINDOW:
            window = (tr.start, tr.end)
        elif ev.name.startswith("benchmark."):
            spans.append((tr.start, tr.end, ev.name[len("benchmark."):]))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    ws, we = window
    spans.sort()
    starts = [a for a, _, _ in spans]

    def around(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else "other"

    kernel_s, kernel_n, span_device_s, span_n = {}, {}, {}, {}
    for _, _, name in spans:
        span_n[name] = span_n.get(name, 0) + 1
    iv = []
    for s, e, name in dev:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        iv.append((s, e))
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-6
        kernel_n[name] = kernel_n.get(name, 0) + 1
        k = around(s)
        span_device_s[k] = span_device_s.get(k, 0.0) + (e - s) * 1e-6
    busy = _merge(iv)
    busy_us = sum(e - s for s, e in busy)
    # idle gaps, each named by the span around its middle (the
    # benchmark's spans do not nest)
    gaps = {}
    edges = [ws] + [x for b in busy for x in b] + [we]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            k = around((s + e) / 2)
            gaps[k] = gaps.get(k, 0.0) + (e - s) * 1e-6
    return TraceSummary(busy_us * 1e-6, (we - ws) * 1e-6, kernel_s, kernel_n,
                        gaps, span_device_s, span_n)


def base_name(name: str) -> str:
    """A device operation's function name without its return type,
    namespaces, template arguments and parameters:
    "(anonymous namespace)::dist_kernel(float const*, ...)" and
    "void window_conv_kernel<128, false>(...)" give "dist_kernel" and
    "window_conv_kernel"."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    n = n.split("(")[0].split("<")[0].strip()
    return n.split("::")[-1]


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
