"""Sparse convolutions as gather-GEMM over precomputed kernel maps, in plain
float32 PyTorch (counterpart of the XLA ops in the JAX package's
``ops/sparse_conv.py``; the strip, factored and z-dilated forms there are
the same math shaped for the TPU and have no counterpart here).

Zero-pad invariant: feature arrays carry zero rows beyond the valid count,
and every op that could break that (bias add, normalization) re-masks.
Maps are int32 with -1 for an absent neighbor.
"""

from __future__ import annotations

import torch


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
    ``kernel_offsets`` order; valid [M] is required with a bias."""
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
    g = masked_gather(x_coarse, up_parent)
    off = up_offset.long()
    acc = torch.zeros((g.shape[0], w.shape[2]), dtype=g.dtype, device=g.device)
    for k in range(w.shape[0]):
        acc = torch.where((off == k)[:, None], g @ w[k], acc)
    return acc


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           valid: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 sparse conv == per-row linear; w [C_in, C_out]."""
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
