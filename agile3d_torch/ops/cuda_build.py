"""Build and load the package's CUDA kernels (``agile3d_torch/csrc/*.cu``).

Each source compiles with nvcc for ``sm_90a`` into its own shared library
with a plain C interface, loaded with ctypes. Nothing here runs at import:
a kernel builds at its first launch (or when ``build()`` is called), into
``agile3d_torch/_build/``, and is rebuilt when its source is newer than the
library. ``build()`` starts one nvcc per stale source, all at once.

nvcc is looked up as ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``,
then on ``PATH``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("banded_conv", "banded_stem")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(source_path(name)))


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source among ``names``, one nvcc process each,
    all running at once. Returns {name: nvcc output} for what was built (the
    ``-Xptxas -v`` report of registers, shared memory and spills). Raises
    RuntimeError with the compiler output if any build fails."""
    stale = [n for n in names if _stale(n)]
    if not stale:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in stale:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
