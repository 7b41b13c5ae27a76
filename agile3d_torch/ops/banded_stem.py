"""k5 stem conv (3 -> 32): a hand-written CUDA kernel for Hopper
(``csrc/banded_stem.cu``) and its plain PyTorch version.

    y[i] = sum_{j<125} bf16(x[k5[i, j]]) @ bf16(w[j]),  f32 accumulation

Replaces the JAX package's ``ops/banded_stem.py::_make_stem_kernel`` (called
through ``banded_stem_conv`` with ``_pack_weights``). The TPU kernel packs
each (dx, dy) z-strip into one 128-lane row and needs a strip plan, a
per-lane rank map and an exception list; the CUDA kernel reads ``k5``
directly. The source file says what bounds it on the H100 and how the
design answers that.

CPU tensors take ``banded_stem_conv_reference``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from agile3d_torch.ops import cuda_build
from agile3d_torch.ops.banded_conv import _check, gather_gemm_bf16

_P, _I = ctypes.c_void_p, ctypes.c_int
KVOL = 125


def banded_stem_conv_reference(x: torch.Tensor, k5: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same bf16 operand rounding,
    f32 accumulation."""
    return gather_gemm_bf16(x, k5, w)


def _lib():
    lib = cuda_build.load("banded_stem")
    fn = lib.agile3d_banded_stem
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


def banded_stem_conv(x: torch.Tensor, k5: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """k5 stem conv. x [N, 3] f32, k5 [N, 125] int32 (-1 absent),
    w [125, 3, cout] f32 -> [N, cout] f32."""
    if x.device.type == "cpu":
        return banded_stem_conv_reference(x, k5, w)
    _check(x, k5, w, k_expect=KVOL)
    if x.shape[1] != 3:
        raise ValueError(f"the stem kernel takes 3 input channels, got {x.shape[1]}")
    n = x.shape[0]
    cout = w.shape[2]
    y = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k5.data_ptr(), w.data_ptr(), y.data_ptr(),
                n, cout, stream)
    if rc != 0:
        raise RuntimeError(f"banded_stem kernel launch failed: CUDA error {rc}")
    banded_stem_conv.launches += 1
    return y


banded_stem_conv.launches = 0
