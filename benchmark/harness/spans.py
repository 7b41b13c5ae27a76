"""The program's own spans in the traced window: what the host was doing
inside ``agile3d_torch`` while the device worked or sat idle.

The program opens its spans with ``agile3d_torch/utils/profiling.py::
annotate``, every name under ``agile3d.`` (``agile3d.server.click``,
``agile3d.engine.round``, ...). They nest, per thread. For each span name,
without the prefix, ``summarize`` gives:

  n            spans in the window
  wall_s       their host time, clipped to the window (inclusive)
  self_s       wall_s less that of their child spans on the same thread
  ops          device operations launched under the span, inclusive: an
               operation belongs to the innermost span open at its launch,
               and to that span's ancestors, whenever it ran
  device_s     those operations' device time in the window
  idle_s       the window's idle gaps charged to the span, inclusive
  idle_self_s  the idle gaps charged to it as the innermost span

An operation's launch is the CUDA runtime call that queued it: the host
event (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)
whose ``id`` is the operation's correlation id, on the thread that made
it. (The operation's ``linked_correlation_id`` names the innermost torch
op around the call, not a span: it is 0 for the port's own kernels,
launched through ctypes, and torch 2.11's events do not carry it.)

A gap is charged whole by the spans open at its midpoint on the launching
thread: the thread that launched most of the window's device operations,
among the threads that hold a program span. A gap under no program span
is charged to ``none``. Spans on other threads (``agile3d.data.prepare``
on a prefetcher's worker, where the profiler records that thread) are
counted and never name a gap; operations launched on a thread that holds
no program span (the autograd engine's device thread, which runs a
backward while the launching thread waits in it) are charged to the
launching thread's spans open at their launch.

The program's spans are not user annotations, so they leave no copy on
the device's timeline: ``trace.summarize`` reads the same with them as
without them. It does not call ``summarize`` here; PERF.md (section 7)
lists what would read this table into the result line.
"""

from __future__ import annotations

import bisect

import torch

from benchmark.harness import trace

PREFIX = "agile3d."
NONE = "none"
# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...), as the profiler names them
RUNTIME = "cu"


class _Thread:
    """One thread's spans, nested: each span's parent, and the innermost
    span at any time as a step function."""

    def __init__(self, spans):
        # spans: [(start, end, name)], clipped to the window
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.parent = [-1] * len(self.spans)
        self.bounds, self.owner = [], []
        stack = []
        for i, (s, e, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                self._step(self.spans[stack.pop()][1], stack)
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)
            self._step(s, stack)
        while stack:
            self._step(self.spans[stack.pop()][1], stack)

    def _step(self, t, stack):
        owner = stack[-1] if stack else -1
        if self.bounds and self.bounds[-1] == t:
            self.owner[-1] = owner
        else:
            self.bounds.append(t)
            self.owner.append(owner)

    def innermost(self, t) -> int:
        k = bisect.bisect_right(self.bounds, t) - 1
        return self.owner[k] if k >= 0 else -1

    def chain(self, i):
        while i >= 0:
            yield i
            i = self.parent[i]


def _new():
    return {"n": 0, "wall_s": 0.0, "self_s": 0.0, "ops": 0, "device_s": 0.0,
            "idle_s": 0.0, "idle_self_s": 0.0}


def _window(events):
    """The window (start, end), its device operations (start, end, event)
    clipped to it, and its idle intervals: the operations and the busy
    union that ``trace.summarize`` takes, so the gaps are its gaps."""
    window = next((ev.time_range.start, ev.time_range.end)
                  for ev in events if ev.name == trace.WINDOW)
    ws, we = window
    ops = []
    for ev in events:
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("benchmark.")):
            s, e = max(ev.time_range.start, ws), min(ev.time_range.end, we)
            if e > s:
                ops.append((s, e, ev))
    busy = trace._merge([(s, e) for s, e, _ in ops])
    edges = [ws] + [x for b in busy for x in b] + [we]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    return window, ops, gaps


def summarize(events) -> dict:
    """{span name: {field: value}} over ``events`` (the profiler's, with
    the benchmark's window span). Times in the profiler's microseconds,
    fields in seconds."""
    events = list(events)
    (ws, we), device_ops, gaps = _window(events)
    by_thread, launches = {}, {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if ev.name.startswith(RUNTIME):
            launches[ev.id] = ev
        elif ev.name.startswith(PREFIX):
            s, e = max(ev.time_range.start, ws), min(ev.time_range.end, we)
            if e > s:
                by_thread.setdefault(getattr(ev, "thread", 0), []).append(
                    (s, e, ev.name[len(PREFIX):]))
    threads = {t: _Thread(sp) for t, sp in by_thread.items()}
    out = {}
    for th in threads.values():
        child = [0.0] * len(th.spans)
        for i, (s, e, _) in enumerate(th.spans):
            if th.parent[i] >= 0:
                child[th.parent[i]] += e - s
        for i, (s, e, name) in enumerate(th.spans):
            rec = out.setdefault(name, _new())
            rec["n"] += 1
            rec["wall_s"] += (e - s) * 1e-6
            rec["self_s"] += (e - s - child[i]) * 1e-6
    launched = [launches.get(getattr(ev, "id", None))
                for _, _, ev in device_ops]
    count = {}
    for call in launched:
        if call is not None:
            count[call.thread] = count.get(call.thread, 0) + 1
    held = {t: c for t, c in count.items() if t in threads} or count
    main = max(held, key=held.get, default=None)

    for (s, e, _), call in zip(device_ops, launched):
        if call is None:
            continue
        th = threads.get(call.thread if call.thread in threads else main)
        for j in th.chain(th.innermost(call.time_range.start)) if th else ():
            rec = out[th.spans[j][2]]
            rec["ops"] += 1
            rec["device_s"] += (e - s) * 1e-6

    th = threads.get(main)
    for s, e in gaps:
        i = th.innermost((s + e) / 2) if th else -1
        if i < 0:
            rec = out.setdefault(NONE, _new())
            rec["idle_s"] += (e - s) * 1e-6
            rec["idle_self_s"] += (e - s) * 1e-6
            continue
        out[th.spans[i][2]]["idle_self_s"] += (e - s) * 1e-6
        for j in th.chain(i):
            out[th.spans[j][2]]["idle_s"] += (e - s) * 1e-6
    return out


def idle_gaps(program: dict | None, top: int = 10) -> list:
    """The ``top`` span names by idle time charged to them as the
    innermost span, [[name, seconds]]."""
    rows = sorted(((n, r["idle_self_s"]) for n, r in (program or {}).items()
                   if r["idle_self_s"] > 0), key=lambda kv: -kv[1])
    return [[n, s] for n, s in rows[:top]]
