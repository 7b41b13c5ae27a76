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

Backward (``GatherConv``): autograd would turn every gather of the forward
into an ``index_put_`` with accumulation, which on CUDA sorts its indices
and sums each run of duplicates serially (every absent neighbour and pad
row reads the one appended zero row: a run as long as the level has
holes). The convs of a pyramid know their inverse maps, so their backward
is gathers and products only: dX is the conv of dY through the inverse map
with each weight's channels swapped, dW one gathered product per offset.
"""

from __future__ import annotations

import torch

from agile3d_torch.utils.profiling import annotate


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


def _gather_conv(x: torch.Tensor, nbr: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """sum_k x[nbr[:, k]] @ w[k], one gathered product per offset."""
    xz = _with_zero_row(x)
    idx = nbr.long()
    acc = xz[idx[:, 0]] @ w[0]
    for k in range(1, w.shape[0]):
        acc = acc + xz[idx[:, k]] @ w[k]
    return acc


def _parent_conv(x: torch.Tensor, parent: torch.Tensor, offset: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """out[n] = x[parent[n]] @ w[offset[n]]; parent -1 gives a zero row."""
    g = masked_gather(x, parent)
    off = offset.long()
    acc = torch.zeros((g.shape[0], w.shape[2]), dtype=g.dtype, device=g.device)
    for k in range(w.shape[0]):
        acc = torch.where((off == k)[:, None], g @ w[k], acc)
    return acc


def _weight_grad(x: torch.Tensor, dy: torch.Tensor, nbr: torch.Tensor,
                 transposed: bool) -> torch.Tensor:
    """dW of ``GatherConv``: per offset one gather (x's rows through the
    neighbour map; for the transposed conv, dY's through ``down``) and one
    product written into its slice."""
    src = _with_zero_row(dy if transposed else x)
    idx = nbr.long()
    dw = x.new_empty((nbr.shape[1], x.shape[1], dy.shape[1]))
    for k in range(nbr.shape[1]):
        g = src[idx[:, k]]
        if transposed:
            torch.mm(x.T, g, out=dw[k])
        else:
            torch.mm(g.T, dy, out=dw[k])
    return dw


def _needs_grad(x: torch.Tensor, w: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


class GatherConv(torch.autograd.Function):
    """A plain conv whose backward gathers through the inverse map and
    never scatters: no ``index_put_``, no sort, and nothing gathered is
    kept from the forward (it saves x and w).

    ``kind`` names the conv, and with it the adjoint its caller vouches
    for; ``maps`` are the level's:
      * ``"stencil"``, ``(nbr,)``: a stride-1 odd stencil on x's own rows
        (k3, the k5 stem). ``nbr[m, k] = n`` exactly when
        ``nbr[n, K-1-k] = m`` (``kernel_offsets`` is symmetric), so dX is
        the conv of dY through the same map with ``flip(w, 0)``, channels
        swapped, as ``BandedConv``'s dX;
      * ``"down"``, ``(down, up_parent, up_offset)``: the conv through
        ``down``; each fine row has one reader, so dX[n] =
        dY[up_parent[n]] @ w[up_offset[n]]^T (parent -1: 0);
      * ``"transposed"``, the same three maps: the conv through
        ``(up_parent, up_offset)``; dX is the conv of dY through ``down``
        with w's channels swapped.
    dW[k] is gather(x, nbr[:, k])^T @ dY, or for the transposed conv
    x^T @ gather(dY, down[:, k]): one gather and one product an offset.
    The sums run in f32 (float64 stays float64); dX comes back in x's dtype
    and dW in w's, each cast once.

    ``backwards`` counts backward calls; ``fallbacks`` counts the convs run
    under autograd with gradients because their caller named no inverse
    (``sparse_conv``, ``sparse_conv_transpose``)."""

    backwards = 0
    fallbacks = 0

    @staticmethod
    def forward(ctx, x, w, kind, maps):
        ctx.save_for_backward(x, w)
        ctx.kind, ctx.maps = kind, maps
        if kind == "transposed":
            return _parent_conv(x, maps[1], maps[2], w)
        return _gather_conv(x, maps[0], w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kind, maps = ctx.kind, ctx.maps
        dx = dw = None
        with annotate("agile3d.ops.conv_grad"):
            # the sums in f32 (float64 stays float64)
            dt = torch.promote_types(dy.dtype, torch.float32)
            g, xs, wt = dy.to(dt), x.to(dt), w.to(dt).transpose(1, 2)
            if ctx.needs_input_grad[0]:
                if kind == "stencil":
                    dx = _gather_conv(g, maps[0], wt.flip(0))
                elif kind == "down":
                    dx = _parent_conv(g, maps[1], maps[2], wt)
                else:
                    dx = _gather_conv(g, maps[0], wt)
                dx = dx.to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _weight_grad(xs, g, maps[0],
                                  kind == "transposed").to(w.dtype)
        GatherConv.backwards += 1
        return dx, dw, None, None


def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None,
                valid: torch.Tensor | None = None, *,
                stencil: bool = False,
                up: tuple | None = None) -> torch.Tensor:
    """out[m] = sum_k x[nbr[m, k]] @ w[k] (+ bias), absent neighbors add 0.

    x [N, C_in] (zero pad rows); nbr [M, K]; w [K, C_in, C_out] in
    ``kernel_offsets`` order; valid [M] is required with a bias. bf16
    operands: the sum in f32, rounded once.

    With gradients the caller names the conv's inverse for ``GatherConv``:
    ``stencil=True``, ``nbr`` is a stride-1 odd stencil on x's own rows;
    ``up=(up_parent, up_offset)`` [N], ``nbr`` is that level's down map.
    With neither (a rank's block of rows followed by its halo) the conv
    takes autograd's backward, counted in ``GatherConv.fallbacks``."""
    x, w = promoted(x, w)
    if x.dtype == torch.bfloat16:
        return sparse_conv(x.float(), nbr, w.float(), bias, valid,
                           stencil=stencil, up=up).to(torch.bfloat16)
    if not _needs_grad(x, w):
        acc = _gather_conv(x, nbr, w)
    elif stencil:
        assert nbr.shape[0] == x.shape[0] and nbr.shape[1] % 2
        acc = GatherConv.apply(x, w, "stencil", (nbr,))
    elif up is not None:
        assert up[0].shape[0] == x.shape[0]
        acc = GatherConv.apply(x, w, "down", (nbr, *up))
    else:
        GatherConv.fallbacks += 1
        acc = _gather_conv(x, nbr, w)
    if bias is not None:
        assert valid is not None, "bias add requires a validity mask"
        acc = acc + bias
    if valid is not None:
        acc = torch.where(valid[:, None], acc, torch.zeros((), dtype=acc.dtype,
                                                           device=acc.device))
    return acc


def sparse_conv_transpose(x_coarse: torch.Tensor, up_parent: torch.Tensor,
                          up_offset: torch.Tensor, w: torch.Tensor, *,
                          down: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv onto the finer level: each fine
    voxel receives exactly its parent's row through kernel element
    ``up_offset``. x_coarse [N_c, C_in]; up_parent/up_offset [N_f];
    w [8, C_in, C_out]. Pad rows (up_parent == -1) come out 0.

    ``down`` [N_c, 8], the fine level's down map (the inverse of
    up_parent / up_offset), gives the conv ``GatherConv``'s backward;
    without it, with gradients, autograd's (counted in
    ``GatherConv.fallbacks``)."""
    x_coarse, w = promoted(x_coarse, w)
    if not _needs_grad(x_coarse, w):
        return _parent_conv(x_coarse, up_parent, up_offset, w)
    if down is not None:
        assert down.shape[0] == x_coarse.shape[0]
        return GatherConv.apply(x_coarse, w, "transposed",
                                (down, up_parent, up_offset))
    GatherConv.fallbacks += 1
    return _parent_conv(x_coarse, up_parent, up_offset, w)


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
