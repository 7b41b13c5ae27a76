"""Sparse convolutions as gather-GEMM over precomputed kernel maps, in plain
PyTorch (counterpart of the XLA ops in the JAX package's
``ops/sparse_conv.py``; the strip, factored and z-dilated forms there are
the same math shaped for the TPU and have no counterpart here).

Dtypes follow JAX's: the operands are promoted to one dtype (an f32 x
against bf16 weights runs in f32, as ``jnp.promote_types`` has it), and
the output is in that dtype. A conv of bf16 operands sums its products in
f32 and rounds once to bf16, as the banded kernels do. The JAX package
keeps a bf16 running sum over its scan or strip steps (``_SCAN_GROUP``
offsets a step, or one strip group), whose step count depends on the TPU
routing; summing per offset in bf16 instead (27 roundings of a k3 conv,
125 of the stem) was measured (PERF.md): within the CPU tests'
bound of JAX's bf16 maps, but on the card the training step's loss moved
22% from f32's (the stem's 125 roundings), against 2.4% with one
rounding.

Zero-pad invariant: feature arrays carry zero rows beyond the valid count,
and every op that could break that (bias add, normalization) re-masks.
Maps are int32 with -1 for an absent neighbor.
"""

from __future__ import annotations

import torch


def promoted(x: torch.Tensor, w: torch.Tensor):
    """x and w in their promoted dtype (``jnp.promote_types``'s for the
    float32 / bfloat16 pair)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """x with one zero row appended, so that index -1 gathers zeros."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def masked_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [N, C] at idx [M]; idx == -1 yields a zero row."""
    return _with_zero_row(x)[idx.long()]


def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """out[m] = sum_k x[nbr[m, k]] @ w[k] (+ bias), absent neighbors add 0.

    x [N, C_in] (zero pad rows); nbr [M, K]; w [K, C_in, C_out] in
    ``kernel_offsets`` order; valid [M] is required with a bias. bf16
    operands: the sum in f32, rounded once."""
    x, w = promoted(x, w)
    if x.dtype == torch.bfloat16:
        return sparse_conv(x.float(), nbr, w.float(), bias,
                           valid).to(torch.bfloat16)
    xz = _with_zero_row(x)
    idx = nbr.long()
    acc = xz[idx[:, 0]] @ w[0]
    for k in range(1, w.shape[0]):
        acc = acc + xz[idx[:, k]] @ w[k]
    if bias is not None:
        assert valid is not None, "bias add requires a validity mask"
        acc = acc + bias
    if valid is not None:
        acc = torch.where(valid[:, None], acc, torch.zeros((), dtype=acc.dtype,
                                                           device=acc.device))
    return acc


def sparse_conv_transpose(x_coarse: torch.Tensor, up_parent: torch.Tensor,
                          up_offset: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv onto the finer level: each fine
    voxel receives exactly its parent's row through kernel element
    ``up_offset``. x_coarse [N_c, C_in]; up_parent/up_offset [N_f];
    w [8, C_in, C_out]. Pad rows (up_parent == -1) come out 0."""
    x_coarse, w = promoted(x_coarse, w)
    g = masked_gather(x_coarse, up_parent)
    off = up_offset.long()
    acc = torch.zeros((g.shape[0], w.shape[2]), dtype=g.dtype, device=g.device)
    for k in range(w.shape[0]):
        acc = torch.where((off == k)[:, None], g @ w[k], acc)
    return acc


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           valid: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 sparse conv == per-row linear; w [C_in, C_out]."""
    x, w = promoted(x, w)
    y = x @ w
    if bias is not None:
        assert valid is not None, "bias add requires a validity mask"
        y = y + bias
    if valid is not None:
        y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))
    return y


def avg_pool_down(x: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 average pooling onto the coarser level (ME
    MinkowskiAvgPooling; reference models/agile3d.py:71): the mean over the
    present children. down [N_coarse, 8] rows into x."""
    total = masked_gather(x, down.reshape(-1)).reshape(
        down.shape[0], down.shape[1], x.shape[1]).sum(1)
    count = (down >= 0).sum(1).to(x.dtype)
    return total / count.clamp(min=1)[:, None]


def sum_pool_down(x: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 sum pooling (ME MinkowskiSumPooling, reference
    models/modules/common.py:240-258)."""
    return masked_gather(x, down.reshape(-1)).reshape(
        down.shape[0], down.shape[1], x.shape[1]).sum(1)


def avg_unpool_up(x_coarse: torch.Tensor,
                  up_parent: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 average unpooling (ME MinkowskiAvgUnpooling,
    reference models/modules/common.py:219-237): each fine row takes its
    parent's value."""
    return masked_gather(x_coarse, up_parent)
