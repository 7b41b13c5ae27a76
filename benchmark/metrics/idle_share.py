"""The share of the traced window, in %, in which no operation ran on the
device (the union of the device operations' intervals, from the profiler's
trace)."""

from benchmark.harness.stats import idle_share


def read(run):
    t = run.trace
    return idle_share(t.busy_s, t.window_s) if t.window_s > 0 else None
