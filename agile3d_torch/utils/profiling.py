"""Profiling and tracing hooks (the port's counterpart of the JAX
package's ``utils/profiling.py``): a profiler trace around a block, named
spans inside it, and the card's memory counters.

    with trace("runs/trace"):
        with annotate("step"):
            ...

``trace`` writes a Chrome / TensorBoard trace (``*.pt.trace.json``) under
``log_dir`` when the block ends, with the CUDA activity when a card is
present; ``annotate`` spans nest and show in it by name.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block, written under ``log_dir``
    when it ends; yields the profiler (its ``key_averages()`` are there
    after the block). A no-op yielding None when ``log_dir`` is falsy."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def start_profiler_server(port: int = 9999):
    """The JAX package starts a profiler server that TensorBoard's capture
    button connects to (``jax.profiler.start_server``). PyTorch has no
    counterpart: its profiler records only inside a ``profile`` block, so
    use ``trace`` around the work instead."""
    raise NotImplementedError(
        f"torch has no on-demand profiler server (port {port}): wrap the "
        f"work in agile3d_torch.utils.profiling.trace(log_dir)")


def device_memory_stats() -> dict:
    """Per CUDA device, {"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"} from PyTorch's caching allocator (what it has handed
    out now and at most since the last ``reset_peak_memory_stats``) and
    the card's total memory, keyed by device name ("cuda:0"); empty
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def annotate(name: str):
    """A named span on the profiler's timeline (a context manager; spans
    nest)."""
    return torch.profiler.record_function(name)
