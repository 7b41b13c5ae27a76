"""The port's profiling hooks (``agile3d_torch/utils/profiling.py``) on
the CPU: the trace file, nested spans, the no-op form, the memory counters
without a card, and the profiler server that torch does not have."""

import glob
import json
import os

import pytest
import torch

from agile3d_torch.utils import profiling


def test_trace_writes_a_trace_with_nested_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("outer_span"):
            with profiling.annotate("inner_span"):
                y = x @ x
    assert prof is not None and y.shape == (64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("name") in ("outer_span", "inner_span")
             and e.get("ph") == "X"}
    assert set(spans) == {"outer_span", "inner_span"}
    outer, inner = spans["outer_span"], spans["inner_span"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer_span", "inner_span"} <= names


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(tmp_path, log_dir):
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("span"):
            torch.ones(3).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_memory_stats_and_the_missing_server():
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats["cuda:0"]) == {"bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit"}
    else:
        assert stats == {}
    with pytest.raises(NotImplementedError, match="trace"):
        profiling.start_profiler_server(9999)
