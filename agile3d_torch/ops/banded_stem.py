"""k5 stem conv (3 -> 32): a hand-written CUDA kernel for Hopper
(``csrc/banded_stem.cu``) and its plain PyTorch version.

    y[i] = sum_{j<125} bf16(x[k5[i, j]]) @ bf16(w[j]),  f32 accumulation

Replaces the JAX package's ``ops/banded_stem.py::_make_stem_kernel`` (called
through ``banded_stem_conv`` with ``_pack_weights``). The TPU kernel packs
each (dx, dy) z-strip into one 128-lane row and needs a strip plan, a
per-lane rank map and an exception list; the CUDA kernel reads ``k5``
directly, streaming it by bulk copy in 64-row tiles (one contiguous run of
``STAGE_BYTES`` each, so ``k5`` must be 16-byte aligned) with the products
on the tensor cores. The source file says what bounds it on the H100 and
how the design answers that.

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
TILE_M = 64                     # output rows per tile (csrc TM)
TILE_N = 32                     # output columns per CTA (csrc BN)
K_PADDED = 512                  # 125 offsets x 4 channels, padded to 32 k16 steps
STAGES = 3                      # the ring of k5 tiles (csrc STAGES)
STAGE_BYTES = TILE_M * KVOL * 4  # one tile's k5 rows


def stem_tiles(n: int) -> int:
    """64-row tiles of an n-row map (the last one may be ragged)."""
    return -(-n // TILE_M)


def stem_weight_image_numel(cout: int) -> int:
    """bf16 elements of the weight image: per 32-column tile, K = 512 by 32
    columns (32 KB)."""
    return -(-cout // TILE_N) * K_PADDED * TILE_N


def stem_smem_bytes() -> int:
    """Dynamic shared memory of the kernel (csrc SMEM): alignment slack,
    one column tile's weight image, the ring and its barriers."""
    return 1024 + K_PADDED * TILE_N * 2 + STAGES * STAGE_BYTES \
        + (2 * STAGES + 1) * 8


def banded_stem_conv_reference(x: torch.Tensor, k5: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same bf16 operand rounding,
    f32 accumulation."""
    return gather_gemm_bf16(x, k5, w)


def _lib():
    lib = cuda_build.load("banded_stem")
    lib.agile3d_banded_stem_prep.argtypes = [_P] * 4 + [_I, _I, _P]
    lib.agile3d_banded_stem.argtypes = [_P] * 4 + [_I, _I, _P]
    lib.agile3d_banded_stem_prep.restype = lib.agile3d_banded_stem.restype = _I
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def stem_prep(x: torch.Tensor, w: torch.Tensor):
    """The kernel's operands, from one prep launch on x's device: x as bf16
    rows padded to 4 channels with a zero row after them ([N + 1, 4]) and
    w as the swizzled weight image (``stem_weight_image_numel(cout)``)."""
    n, cout = x.shape[0], w.shape[2]
    xb = torch.empty((n + 1, 4), dtype=torch.bfloat16, device=x.device)
    wimg = torch.empty(stem_weight_image_numel(cout), dtype=torch.bfloat16,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_lib().agile3d_banded_stem_prep(
            x.data_ptr(), w.data_ptr(), xb.data_ptr(), wimg.data_ptr(), n,
            cout, stream), "banded_stem prep")
    return xb, wimg


def banded_stem_conv(x: torch.Tensor, k5: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """k5 stem conv. x [N, 3] f32, k5 [N, 125] int32 (-1 absent, 16-byte
    aligned), w [125, 3, cout] f32 -> [N, cout] f32."""
    if x.device.type == "cpu":
        return banded_stem_conv_reference(x, k5, w)
    _check(x, k5, w, k_expect=KVOL)
    if x.shape[1] != 3:
        raise ValueError(f"the stem kernel takes 3 input channels, got {x.shape[1]}")
    if k5.data_ptr() % 16:
        raise ValueError("k5 must start on a 16-byte boundary (the kernel "
                         "reads it by bulk copy); a sliced view is not")
    n, cout = x.shape[0], w.shape[2]
    xb, wimg = stem_prep(x, w)
    y = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_lib().agile3d_banded_stem(
            xb.data_ptr(), k5.data_ptr(), wimg.data_ptr(), y.data_ptr(), n,
            cout, stream), "banded_stem kernel")
    banded_stem_conv.launches += 1
    return y


banded_stem_conv.launches = 0
