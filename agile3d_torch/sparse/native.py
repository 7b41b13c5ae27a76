"""The port's native host runtime: ``csrc/sparse_index.cpp`` through ctypes.

Quantization, the neighbour maps and the stride-2 steps of the pyramid in
C++ (``sparse_quantize`` and ``build_pyramid`` call them by default). The
library builds with g++ at first use, never at import, into
``agile3d_torch/_build/``, and again when the source is newer: under a file
lock, into a file of its own, then renamed into place, so that processes
starting together build it once and never load half a file. A failed build
raises with the compiler's output; nothing falls back quietly.

``AGILE3D_NATIVE=0`` in the environment selects the numpy path instead
(read at each call). Both paths give the same arrays bit for bit
(``tests/test_torch_native.py``). ctypes releases the GIL during a call,
so a prefetch thread's host prep overlaps the launch loop.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "sparse", "csrc", "sparse_index.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libsparse_index.so")
# an ISO -std: g++ contracts no floating-point expression under it
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def enabled() -> bool:
    """Whether host prep takes the native path (``AGILE3D_NATIVE`` unset or
    not "0")."""
    return os.environ.get("AGILE3D_NATIVE", "1") != "0"


@contextlib.contextmanager
def disabled():
    """The numpy path inside the block (``AGILE3D_NATIVE=0``), for every
    thread of the process."""
    old = os.environ.get("AGILE3D_NATIVE")
    os.environ["AGILE3D_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["AGILE3D_NATIVE"]
        else:
            os.environ["AGILE3D_NATIVE"] = old


def _stale() -> bool:
    return (not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE))


def build() -> bool:
    """Build the library if it is missing or older than its source. Returns
    whether this call compiled it. Raises RuntimeError with g++'s output if
    the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "sparse_index.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not _stale():
            return False
        tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ did not run ({e}): the native host "
                               f"runtime needs it, or AGILE3D_NATIVE=0") from e
        if out.returncode != 0:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{out.stderr}")
        os.replace(tmp, LIBRARY)
        return True


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            i64, f64 = ctypes.c_int64, ctypes.c_double
            i32p, i64p, f32p = (
                np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                for t in (np.int32, np.int64, np.float32))
            lib.agile3d_quantize.restype = i64
            lib.agile3d_quantize.argtypes = [f32p, i64, f64, i32p, i64p,
                                             i64p]
            lib.agile3d_neighbor_map.restype = i64
            lib.agile3d_neighbor_map.argtypes = [i32p, i32p, i64, i32p, i64,
                                                 i32p]
            lib.agile3d_stride_down.restype = i64
            lib.agile3d_stride_down.argtypes = [i32p, i32p, i64, i32p, i32p,
                                                i32p, i32p, i32p]
            _lib = lib
        return _lib


def _range_error() -> ValueError:
    return ValueError("coordinates out of packable range +-262140")


def quantize(coords: np.ndarray, qsize: float):
    """(vox int32 [M, 3], unique_map int64 [M], inverse_map int64 [N]) of
    float32 points [N, 3], as ``quantize.sparse_quantize``."""
    coords = np.ascontiguousarray(coords, np.float32)
    n = len(coords)
    vox = np.empty((n, 3), np.int32)
    umap = np.empty(n, np.int64)
    imap = np.empty(n, np.int64)
    m = get_lib().agile3d_quantize(coords, n, float(qsize), vox, umap, imap)
    if m < 0:
        raise _range_error()
    return vox[:m].copy(), umap[:m].copy(), imap


def neighbor_map(grid: np.ndarray, batch: np.ndarray,
                 offsets: np.ndarray) -> np.ndarray:
    """out [N, K]: the row at grid[i] + offsets[j] of the same item, -1
    where absent."""
    grid = np.ascontiguousarray(grid, np.int32)
    batch = np.ascontiguousarray(batch, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    n, k = len(grid), len(offsets)
    out = np.empty((n, k), np.int32)
    if get_lib().agile3d_neighbor_map(grid, batch, n, offsets, k, out) < 0:
        raise _range_error()
    return out


def stride_down(grid: np.ndarray, batch: np.ndarray):
    """(coarse_grid [M, 3], coarse_batch [M], parent [N], child_offset [N],
    down [M, 8]) of one stride-2 step, the coarse rows sorted by packed
    key."""
    grid = np.ascontiguousarray(grid, np.int32)
    batch = np.ascontiguousarray(batch, np.int32)
    n = len(grid)
    coarse_grid = np.empty((n, 3), np.int32)
    coarse_batch = np.empty(n, np.int32)
    parent = np.empty(n, np.int32)
    child_off = np.empty(n, np.int32)
    down = np.empty((n, 8), np.int32)
    m = get_lib().agile3d_stride_down(grid, batch, n, coarse_grid,
                                      coarse_batch, parent, child_off, down)
    if m < 0:
        raise _range_error()
    return (coarse_grid[:m].copy(), coarse_batch[:m].copy(), parent,
            child_off, down[:m].copy())
