"""Banded k3 sparse conv: a hand-written CUDA kernel for Hopper
(``csrc/banded_conv.cu``) and its plain PyTorch version.

    y[i] = sum_j bf16(x[k3[i, j]]) @ bf16(w[j]),  f32 accumulation, f32 out

Replaces the JAX package's ``ops/banded_conv.py::_make_kernel`` (called through
``banded_conv``). The TPU kernel stages a window of sorted rows in VMEM and
gathers them with one-hot band matmuls, with a host-built window plan and an
exception list for neighbours outside the band; the CUDA kernel gathers rows
by index from device memory, so it takes ``k3`` alone. The source file says
what bounds it on the H100 and how the design answers that.

General in cin and cout (the training slice reuses it for dX with
``flip(w, 0).swapaxes(1, 2)``). CPU tensors take ``banded_conv_reference``;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from agile3d_torch.ops import cuda_build
from agile3d_torch.ops.sparse_conv import masked_gather

_P, _I = ctypes.c_void_p, ctypes.c_int


def gather_gemm_bf16(x: torch.Tensor, nbr: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """sum_j bf16(x[nbr[:, j]]) @ bf16(w[j]) with f32 accumulation, as one
    [M, K*cin] @ [K*cin, cout] product of bf16-rounded values in f32."""
    m, k = nbr.shape
    _, cin, cout = w.shape
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    g = masked_gather(xb, nbr.reshape(-1)).reshape(m, k * cin)
    return g @ wb.reshape(k * cin, cout)


def banded_conv_reference(x: torch.Tensor, k3: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same bf16 operand rounding,
    f32 accumulation."""
    return gather_gemm_bf16(x, k3, w)


def _check(x, nbr, w, k_expect=None):
    if not (x.is_cuda and nbr.device == x.device and w.device == x.device):
        raise ValueError("x, the map and w must be on one CUDA device")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32, got {x.dtype}, {w.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"the neighbour map must be int32, got {nbr.dtype}")
    if not (x.is_contiguous() and nbr.is_contiguous() and w.is_contiguous()):
        raise ValueError("x, the map and w must be contiguous")
    if x.dim() != 2 or nbr.dim() != 2 or w.dim() != 3:
        raise ValueError(f"bad ranks {tuple(x.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(w.shape)}")
    if nbr.shape[0] != x.shape[0] or nbr.shape[1] != w.shape[0] \
            or w.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)}, map "
                         f"{tuple(nbr.shape)}, w {tuple(w.shape)}")
    if k_expect is not None and w.shape[0] != k_expect:
        raise ValueError(f"expected {k_expect} kernel offsets, got {w.shape[0]}")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{x.shape[0]} rows exceed the kernel's int32 range")


def _lib():
    lib = cuda_build.load("banded_conv")
    fn = lib.agile3d_banded_conv
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def banded_conv(x: torch.Tensor, k3: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Banded k3 conv. x [N, cin] f32, k3 [N, K] int32 (-1 absent),
    w [K, cin, cout] f32 -> [N, cout] f32."""
    if x.device.type == "cpu":
        return banded_conv_reference(x, k3, w)
    _check(x, k3, w)
    n, cin = x.shape
    k, _, cout = w.shape
    cinp = -(-cin // 32) * 32  # the kernel's bf16 rows, padded to 32 channels
    y = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    xb = torch.empty((n, cinp), dtype=torch.bfloat16, device=x.device)
    wt = torch.empty((k, cout, cinp), dtype=torch.bfloat16, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k3.data_ptr(), w.data_ptr(), y.data_ptr(),
                xb.data_ptr(), wt.data_ptr(), n, k, cin, cinp, cout, stream)
    if rc != 0:
        raise RuntimeError(f"banded_conv kernel launch failed: CUDA error {rc}")
    banded_conv.launches += 1
    return y


banded_conv.launches = 0
