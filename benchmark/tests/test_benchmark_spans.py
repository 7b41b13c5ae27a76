"""The program's spans on synthetic timelines (``harness/spans.py``)."""

import torch

from benchmark.harness import spans, trace

MAIN, WORKER, AUTOGRAD = 1, 2, 3


class _Ev:
    """A profiler event. A device operation's ``id`` is its correlation
    id, which the CUDA runtime call that launched it shares."""

    def __init__(self, name, s, e, dev=False, thread=MAIN, id=0):
        self.name = name
        self.time_range = type("R", (), {"start": s, "end": e})()
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)
        self.thread, self.id = thread, id


def _timeline():
    """A window of 1000 us: a round (100-600) holding a decoder (150-350)
    whose launch (202-205, inside an op) queues a kernel that runs at
    700-800, after both closed; a click simulation (400-500) whose launch
    (410-412, no op around it, as the port's own kernels) queues one run
    at 420-480; a worker's prepare across the idle middle; a benchmark
    span (50-950), whose copy on the device's timeline (400-800) is no
    operation. The ops' ids collide with the operations' (torch's and
    CUPTI's counters do)."""
    return [_Ev(trace.WINDOW, 0, 1000, id=1),
            _Ev("benchmark.scene", 50, 950, id=8),
            _Ev("agile3d.engine.round", 100, 600, id=2),
            _Ev("agile3d.model.decoder", 150, 350, id=3),
            _Ev("aten::mm", 200, 210, id=100),
            _Ev("cudaLaunchKernel", 202, 205, id=100),
            _Ev("agile3d.engine.clicks", 400, 500, id=101),
            _Ev("cudaLaunchKernel", 410, 412, id=101),
            _Ev("agile3d.data.prepare", 500, 900, thread=WORKER, id=7),
            _Ev("k_mm", 700, 800, dev=True, id=100),
            _Ev("k_dist", 420, 480, dev=True, id=101),
            _Ev("benchmark.scene", 400, 800, dev=True, id=8)]


def test_the_gaps_are_the_traces_gaps():
    evs = _timeline()
    s, p = trace.summarize(evs), spans.summarize(evs)
    assert set(s.kernel_n) == {"k_mm", "k_dist"}
    assert abs(s.busy_s - 160e-6) < 1e-12
    total = sum(r["idle_self_s"] for r in p.values())
    assert abs(total - (s.window_s - s.busy_s)) < 1e-12
    assert abs(total - sum(s.gaps.values())) < 1e-12


def test_an_operation_belongs_to_the_span_open_at_its_launch():
    p = spans.summarize(_timeline())
    dec, rnd, clk = p["model.decoder"], p["engine.round"], p["engine.clicks"]
    assert dec["ops"] == 1 and abs(dec["device_s"] - 100e-6) < 1e-12
    assert clk["ops"] == 1 and abs(clk["device_s"] - 60e-6) < 1e-12
    # inclusive: the round holds both
    assert rnd["ops"] == 2 and abs(rnd["device_s"] - 160e-6) < 1e-12
    assert rnd["n"] == dec["n"] == 1
    assert abs(rnd["wall_s"] - 500e-6) < 1e-12
    assert abs(rnd["self_s"] - 200e-6) < 1e-12
    # the worker's span is counted
    assert p["data.prepare"]["n"] == 1 and p["data.prepare"]["ops"] == 0


def test_a_gap_is_named_by_the_launching_threads_innermost_span():
    p = spans.summarize(_timeline())
    # gaps: 0-420 (mid 210: the decoder), 480-700 (mid 590: the round,
    # although the worker's prepare is open there), 800-1000 (none)
    assert abs(p["model.decoder"]["idle_self_s"] - 420e-6) < 1e-12
    assert abs(p["engine.round"]["idle_self_s"] - 220e-6) < 1e-12
    assert abs(p["engine.round"]["idle_s"] - 640e-6) < 1e-12
    assert abs(p["none"]["idle_self_s"] - 200e-6) < 1e-12
    assert p["data.prepare"]["idle_s"] == 0.0
    assert p["engine.clicks"]["idle_s"] == 0.0
    assert spans.idle_gaps(p)[0] == ["model.decoder", p["model.decoder"][
        "idle_self_s"]]


def test_a_backward_thread_charges_the_launching_threads_span():
    evs = [_Ev(trace.WINDOW, 0, 1000, id=1),
           _Ev("agile3d.engine.step", 100, 900, id=2),
           _Ev("cudaLaunchKernel", 150, 160, id=100),
           _Ev("cudaLaunchKernel", 170, 180, id=101),
           _Ev("cudaLaunchKernel", 300, 310, thread=AUTOGRAD, id=102),
           _Ev("cudaLaunchKernel", 320, 330, thread=AUTOGRAD, id=103),
           _Ev("k", 200, 250, dev=True, id=100),
           _Ev("k", 260, 280, dev=True, id=101),
           _Ev("k_bwd", 400, 500, dev=True, id=102),
           _Ev("k_bwd", 500, 520, dev=True, id=103)]
    p = spans.summarize(evs)
    # the backward thread launched as many as the main one, which alone
    # holds a span: it names the gaps, and its step takes all four
    assert p["engine.step"]["ops"] == 4
    assert abs(p["engine.step"]["device_s"] - 190e-6) < 1e-12
    assert set(p) == {"engine.step"}
    assert abs(p["engine.step"]["idle_self_s"] - 810e-6) < 1e-12


def test_no_program_span_charges_every_gap_to_none():
    evs = [_Ev(trace.WINDOW, 0, 1000, id=1),
           _Ev("cudaLaunchKernel", 10, 20, id=100),
           _Ev("k", 100, 300, dev=True, id=100)]
    p = spans.summarize(evs)
    assert set(p) == {"none"}
    assert abs(p["none"]["idle_self_s"] - 800e-6) < 1e-12
