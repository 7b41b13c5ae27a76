"""Row gather from a table held in shared memory: a hand-written CUDA
kernel for Hopper (``csrc/row_gather.cu``) and its plain PyTorch version.

    out[i] = x[idx[i]],  x [W, C] f32 resident in the shared memory of a
                         thread-block cluster (each of its 16 CTAs
                         holds ceil(W / 16) rows)

Replaces the TPU probe ``tools/probe_vmem_gather.py``'s ``gather_kernel``
and ``gather_kernel_ta``: one function (a row gather from a VMEM-resident
table) in two Mosaic lowering forms, hence one kernel here. Its only
caller is the probe ``agile3d_torch/tools/probe_smem_gather.py``, which
measures the card's row-gather rate from shared memory beside the L2 and
device-memory gathers of ``torch.index_select``.

CPU tensors take ``row_gather_reference``; CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from agile3d_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
SMEM_MAX = 232448  # shared memory one block may use on the H100 (227 KB)
SLICE_MAX = SMEM_MAX - 16  # of which the table's slice (less the mbarrier)
CLUSTER = 16  # CTAs a table is spread over (timed against 1-8 on the H100)
TABLE_MAX = CLUSTER * SLICE_MAX  # the largest table: 3,718,912 bytes


def row_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x[idx]``."""
    return x[idx.long()]


def gather_work(w: int, c: int, m: int,
                itemsize: int = 4) -> tuple[float, float]:
    """(operations, bytes) of gathering m rows of a [w, c] table of
    ``itemsize``-byte values: no arithmetic; the table read once, the int32
    indices read once and the [m, c] output written once."""
    return 0.0, float(itemsize * (w * c + m * c) + 4 * m)


def slice_bytes(w: int, c: int) -> int:
    """Bytes of the table one CTA holds: ceil(w / CLUSTER) rows of c f32."""
    return -(-w // CLUSTER) * c * 4


def _lib():
    lib = cuda_build.load("row_gather")
    fn = lib.agile3d_smem_row_gather
    fn.argtypes = [_P, _P, _P, _I, _I, ctypes.c_int64, _P]
    fn.restype = _I
    return fn


def smem_row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [W, C] f32 that fits a cluster's shared memory (``TABLE_MAX``
    bytes), idx [M] int32 in [0, W) -> [M, C] f32."""
    if x.device.type == "cpu":
        return row_gather_reference(x, idx)
    if not (x.is_cuda and idx.device == x.device):
        raise ValueError("x and idx must be on one CUDA device")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"x must be float32 and idx int32, got {x.dtype}, "
                        f"{idx.dtype}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"bad ranks {tuple(x.shape)}, {tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()) \
            or x.data_ptr() % 16 != 0:
        raise ValueError("x and idx must be contiguous, x 16-byte aligned")
    w, c = x.shape
    if c % 4 != 0:
        raise ValueError(f"{c} channels: the kernel copies 16-byte pieces, "
                         "so C must be a multiple of 4")
    if slice_bytes(w, c) > SLICE_MAX:
        raise ValueError(f"a {w} x {c} f32 table ({w * c * 4} bytes) exceeds "
                         f"the shared memory of a {CLUSTER}-CTA cluster "
                         f"({TABLE_MAX} bytes)")
    m = idx.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), w, c, m,
                stream)
    if rc != 0:
        raise RuntimeError(f"smem_row_gather kernel launch failed: CUDA error {rc}")
    smem_row_gather.launches += 1
    return out


smem_row_gather.launches = 0
