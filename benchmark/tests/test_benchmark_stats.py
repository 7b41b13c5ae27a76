"""The metric arithmetic on synthetic timelines."""

import numpy as np
import torch

from benchmark.harness import stats, trace


def test_p95_is_over_every_click():
    ms = list(range(1, 101))
    assert stats.percentile(ms, 95) == np.percentile(ms, 95)
    assert stats.percentile(ms + [1000.0], 95) > stats.percentile(ms, 95)
    assert np.isnan(stats.percentile([], 95))


def test_rate_is_over_whole_units():
    # 3 steps of 5 scenes ending at 4, 8 and 12 s after a start at 0
    assert stats.rate(15, 0.0, 12.0) == 1.25
    assert np.isnan(stats.rate(0, 1.0, 1.0))


class _Ev:
    def __init__(self, name, s, e, dev):
        self.name = name
        self.time_range = type("R", (), {"start": s, "end": e})()
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)


def test_idle_share_and_gaps():
    evs = [_Ev(trace.WINDOW, 0, 1000, False),
           _Ev("benchmark.click", 100, 400, False),
           _Ev("benchmark.host", 400, 600, False),
           _Ev("benchmark.click", 600, 900, False),
           _Ev("benchmark.click", 600, 900, True),   # a span's device echo
           _Ev("k1", 150, 350, True), _Ev("k2", 300, 380, True),
           _Ev("k1", 650, 850, True)]
    s = trace.summarize(evs)
    assert s.window_s == 1e-3
    assert abs(s.busy_s - 430e-6) < 1e-12
    assert abs(stats.idle_share(s.busy_s, s.window_s) - 57.0) < 1e-9
    assert abs(s.kernel_s["k1"] - 400e-6) < 1e-12 and s.kernel_n["k1"] == 2
    assert s.span_n == {"click": 2, "host": 1}
    assert abs(s.span_device_s["click"] - 480e-6) < 1e-12
    # a gap goes whole to the span around its middle
    assert abs(s.gaps["host"] - 270e-6) < 1e-12
    assert abs(s.gaps["other"] - 300e-6) < 1e-12
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= 10
