"""Profiling and tracing hooks (the port's counterpart of the JAX
package's ``utils/profiling.py``): a profiler trace around a block, named
spans inside it, the card's memory counters, and the launch counts of the
port's kernels (``kernel_launches``).

    with trace("runs/trace"):
        evaluate_dataset(engine, dataset, "val.csv")

``trace`` writes a Chrome / TensorBoard trace (``*.pt.trace.json``) under
``log_dir`` when the block ends, with the CUDA activity when a card is
present. The program opens its spans with ``annotate`` at the boundaries
of its layers, every name under ``agile3d.`` (``agile3d.server.click``,
``agile3d.engine.round``, ``agile3d.model.decoder``, ...; PERF.md lists
them); they nest, per thread, and show in the trace by name. With no
profiler recording a span costs one flag read.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity

# what ``annotate`` returns while no profiler records: one object, reused
# (a ``nullcontext`` nests and re-enters)
NO_SPAN = contextlib.nullcontext()


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
    nest, per thread). While no profiler records it is ``NO_SPAN``, which
    enters nothing: the span costs a flag read. A span never waits on the
    device.

    The span is a function-scope record (torch's ``_RecordFunctionFast``,
    as compiled graphs name themselves), not a user annotation: the
    profiler copies a user annotation onto the device's timeline, over
    the operations launched inside it, where a reader of that timeline
    would count it as device work. The program's spans stay on the host's
    timeline; the device operations point back to them through their
    launches."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _RecordFunctionFast(name)


def kernel_wrappers() -> dict:
    """Every CUDA kernel wrapper of the port by name; each counts in
    ``.launches`` where it launches its kernel (a CPU tensor's plain
    version does not count)."""
    from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_dw
    from agile3d_torch.ops.banded_stem import banded_stem_conv
    from agile3d_torch.ops.banded_window import banded_window_conv
    from agile3d_torch.ops.boundary_dist import boundary_distances_all
    from agile3d_torch.ops.row_gather import smem_row_gather

    return {"banded_conv": banded_conv, "banded_conv_dw": banded_conv_dw,
            "banded_stem": banded_stem_conv,
            "banded_window_conv": banded_window_conv,
            "smem_row_gather": smem_row_gather,
            "boundary_distances_all": boundary_distances_all}


def kernel_launches() -> dict:
    """Each kernel's launches in this process so far, by wrapper name."""
    return {k: w.launches for k, w in kernel_wrappers().items()}
