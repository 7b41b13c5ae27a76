"""Banded k3 sparse conv: hand-written CUDA kernels for Hopper
(``csrc/banded_conv.cu``) and their plain PyTorch versions.

    y[i] = sum_j bf16(x[k3[i, j]]) @ bf16(w[j]),  f32 accumulation

Replaces the JAX package's ``ops/banded_conv.py::_make_kernel`` (called through
``banded_conv``). The TPU kernel stages a window of sorted rows in VMEM and
gathers them with one-hot band matmuls, with a host-built window plan and an
exception list for neighbours outside the band; the CUDA kernel gathers rows
by index from device memory, so it takes ``k3`` alone: each CTA finds the
window of sorted rows that its neighbours of one dx span from the map
itself (no host plan). The source file says what bounds it on the H100 and
how the design answers that: warp-specialised wgmma kernels on mbarrier
rings, with the operand that all CTAs share (the weights; for dW the rows
of g) cast once per call into its swizzled shared-memory image.

General in cin and cout. Training goes through ``BandedConv``, whose
backward reuses the kernel for dX (``transposed=True``: the forward's
weights read as ``flip(w, 0).swapaxes(1, 2)`` by the weight cast, no copy)
and launches the second kernel of the source for dW (``banded_conv_dw``,
which replaces ``_make_dw_kernel``). CPU tensors take
``banded_conv_reference`` / ``banded_conv_dw_reference``; CUDA tensors
launch the kernels or raise.
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


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def is_bf16(t: torch.Tensor) -> int:
    """The kernels' dtype flag of an operand: 1 for bf16, 0 for f32."""
    return int(t.dtype == torch.bfloat16)


def _check_operands(x, nbr, other, what: str) -> None:
    """Device, type, contiguity and row-count checks shared by the
    wrappers: x [N, cin] and ``other`` each float32 or bfloat16, the map
    int32, all contiguous on one CUDA device."""
    if not (x.is_cuda and nbr.device == x.device and other.device == x.device):
        raise ValueError(f"x, the map and {what} must be on one CUDA device")
    if x.dtype not in OPERAND_DTYPES or other.dtype not in OPERAND_DTYPES:
        raise TypeError(f"x and {what} must be float32 or bfloat16, got "
                        f"{x.dtype}, {other.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"the neighbour map must be int32, got {nbr.dtype}")
    if not (x.is_contiguous() and nbr.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"x, the map and {what} must be contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{x.shape[0]} rows exceed the kernel's int32 range")


def _check(x, nbr, w, k_expect=None, transposed=False):
    _check_operands(x, nbr, w, "w")
    if x.dim() != 2 or nbr.dim() != 2 or w.dim() != 3:
        raise ValueError(f"bad ranks {tuple(x.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(w.shape)}")
    if nbr.shape[0] != x.shape[0] or nbr.shape[1] != w.shape[0] \
            or w.shape[2 if transposed else 1] != x.shape[1]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)}, map "
                         f"{tuple(nbr.shape)}, w {tuple(w.shape)}")
    if k_expect is not None and w.shape[0] != k_expect:
        raise ValueError(f"expected {k_expect} kernel offsets, got {w.shape[0]}")


def conv_tile_n(cout: int) -> int:
    """Output columns per CTA of the conv kernel (csrc ``conv_tile_n``):
    the narrowest wgmma width of 32, 64, 96, 128 that holds cout, at most
    128 (wider outputs take several tiles)."""
    return next(n for n in (32, 64, 96, 128) if cout <= n or n == 128)


def conv_cinp(cin: int) -> int:
    """Channels of the conv kernel's bf16 rows: cin padded to 16 (one
    wgmma k-step); a stage takes 64 of them, the last stage fewer."""
    return -(-cin // 16) * 16


def weight_image_numel(k: int, cin: int, cout: int) -> int:
    """bf16 elements of the conv kernel's weight image: per column tile
    and stage (offset x 64-channel slice), a [tile, 64] swizzled run."""
    bn = conv_tile_n(cout)
    return -(-cout // bn) * k * -(-conv_cinp(cin) // 64) * bn * 64


def _lib():
    lib = cuda_build.load("banded_conv")
    fn = lib.agile3d_banded_conv
    fn.argtypes = [_P, _P, _P, _P, _P, _P] + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def banded_conv(x: torch.Tensor, k3: torch.Tensor, w: torch.Tensor, *,
                transposed: bool = False) -> torch.Tensor:
    """Banded k3 conv. x [N, cin], k3 [N, K] int32 (-1 absent),
    w [K, cin, cout] -> [N, cout] in x's dtype (the f32 sum cast, as the
    JAX package's ``_conv3`` casts the TPU kernel's); x and w each float32
    or bfloat16. With ``transposed``, w is a forward conv's [K, cout, cin]
    weights and the conv uses ``flip(w, 0).transpose(1, 2)`` (the dX of
    that forward)."""
    if x.device.type == "cpu":
        if transposed:
            w = w.flip(0).transpose(1, 2)
        return banded_conv_reference(x, k3, w).to(x.dtype)
    _check(x, k3, w, transposed=transposed)
    n, cin = x.shape
    k, cout = w.shape[0], w.shape[1 if transposed else 2]
    cinp = conv_cinp(cin)
    y = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    xb = torch.empty((n, cinp), dtype=torch.bfloat16, device=x.device)
    wimg = torch.empty(weight_image_numel(k, cin, cout), dtype=torch.bfloat16,
                       device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k3.data_ptr(), w.data_ptr(), y.data_ptr(),
                xb.data_ptr(), wimg.data_ptr(), n, k, cin, cinp, cout,
                int(transposed), is_bf16(x), is_bf16(w), stream)
    if rc != 0:
        raise RuntimeError(f"banded_conv kernel launch failed: CUDA error {rc}")
    banded_conv.launches += 1
    return y.to(x.dtype)


banded_conv.launches = 0


# ---------------------------------------------------------------------------
# Backward: dW kernel and the autograd Function
# ---------------------------------------------------------------------------

DW_MAX_CHUNK = 8192  # the dW kernel's most rows per CTA (csrc DW_CHUNK)
_DW_MIN_BLOCKS = 264  # two waves of one CTA on each of the H100's 132 SMs


def banded_conv_dw_reference(x: torch.Tensor, k3: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dW kernel:
    dw[j] = sum_m bf16(x[k3[m, j]])^T @ bf16(g[m]), f32 accumulation,
    [K, cin, cout]."""
    m, k = k3.shape
    cin = x.shape[1]
    xb = x.to(torch.bfloat16).float()
    gb = g.to(torch.bfloat16).float()
    gathered = masked_gather(xb, k3.reshape(-1)).reshape(m, k * cin)
    return (gathered.T @ gb).reshape(k, cin, g.shape[1])


def dw_tile_n(cout: int) -> int:
    """Output columns per CTA of the dW kernel (csrc ``dw_tile_n``): 64,
    96 or 128 (wider outputs take several tiles)."""
    return 64 if cout <= 64 else 96 if cout <= 96 else 128


def dw_chunk(n: int, k: int, cin: int, cout: int) -> int:
    """Rows per CTA of the dW kernel: chunks of up to DW_MAX_CHUNK rows,
    split smaller (not below 512) until the grid has about two waves of
    CTAs. A multiple of 64 (the kernel's stage); the grid has
    ceil(n / chunk) chunks, each over pairs of offsets, 128-channel tiles
    and column tiles."""
    tiles = -(-k // 2) * -(-cin // 128) * -(-cout // dw_tile_n(cout))
    nchunks = max(-(-n // DW_MAX_CHUNK),
                  min(-(-n // 512), -(-_DW_MIN_BLOCKS // tiles)))
    rows = -(-n // nchunks)
    return max(64, -(-rows // 64) * 64)


def row_image_numel(n: int, cout: int) -> int:
    """bf16 elements of the dW kernel's image of g: per 64 rows, each
    column tile's 64-column atoms, swizzled."""
    bn = dw_tile_n(cout)
    return -(-n // 64) * 64 * -(-cout // bn) * -(-bn // 64) * 64


def _lib_dw():
    lib = cuda_build.load("banded_conv")
    fn = lib.agile3d_banded_conv_dw
    fn.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def banded_conv_dw(x: torch.Tensor, k3: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the banded k3 conv. x [N, cin], k3 [N, K] int32
    (-1 absent), g [N, cout], x and g each float32 or bfloat16 -> dw [K,
    cin, cout] f32."""
    if x.device.type == "cpu":
        return banded_conv_dw_reference(x, k3, g)
    _check_operands(x, k3, g, "g")
    if x.dim() != 2 or k3.dim() != 2 or g.dim() != 2 \
            or k3.shape[0] != x.shape[0] or g.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)}, map "
                         f"{tuple(k3.shape)}, g {tuple(g.shape)}")
    n, cin = x.shape
    k, cout = k3.shape[1], g.shape[1]
    cinp = -(-cin // 8) * 8
    chunk = dw_chunk(n, k, cin, cout)
    dev = x.device
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dev)
    xb = torch.empty((n, cinp), dtype=torch.bfloat16, device=dev)
    gimg = torch.empty(row_image_numel(n, cout), dtype=torch.bfloat16,
                       device=dev)
    part = torch.empty((max(1, -(-n // chunk)), k, cin, cout),
                       dtype=torch.float32, device=dev)
    fn = _lib_dw()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k3.data_ptr(), g.data_ptr(), dw.data_ptr(),
                xb.data_ptr(), gimg.data_ptr(), part.data_ptr(), n, k, cin,
                cinp, cout, chunk, is_bf16(x), is_bf16(g), stream)
    if rc != 0:
        raise RuntimeError(f"banded_conv_dw kernel launch failed: CUDA error {rc}")
    banded_conv_dw.launches += 1
    return dw


banded_conv_dw.launches = 0


class BandedConv(torch.autograd.Function):
    """``banded_conv`` with its backward on the same kernels, as the JAX
    package's custom VJP (``ops/banded_conv.py::_make_vjp_conv``):

      dX = banded_conv(g, k3, w, transposed=True), the conv with
           flip(w, 0)^T: for a stride-1 cubic stencil on one coordinate
           set, the transpose of offset j's map is offset k-1-j's map
           (``kernel_offsets`` is symmetric), so the forward kernel
           computes dX with reversed, channel-transposed weights (read so
           by its weight cast: no copy);
      dW = banded_conv_dw(x, k3, g).

    dX comes back in x's dtype and dW in w's, as the JAX package's VJP
    casts them (``ops/banded_conv.py``'s ``bwd``). CPU tensors take the
    plain versions of both kernels."""

    @staticmethod
    def forward(ctx, x, k3, w):
        ctx.save_for_backward(x, k3, w)
        return banded_conv(x, k3, w)

    @staticmethod
    def backward(ctx, g):
        x, k3, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = banded_conv(g, k3, w, transposed=True).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = banded_conv_dw(x, k3, g).to(w.dtype)
        return dx, None, dw
