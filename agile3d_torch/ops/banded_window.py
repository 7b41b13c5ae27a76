"""Windowed banded k3 conv: a hand-written CUDA kernel for Hopper
(``csrc/banded_window.cu``), its host plan and its plain PyTorch version.

    y[i] = sum_j bf16(x[k3[i, j]]) @ bf16(w[j]),  f32 accumulation,

over the neighbours that lie inside the window of block(i) for
cluster(j); a neighbour outside its window contributes nothing, as in the
TPU probe this replaces (``tools/probe_banded_kernel.py::make_banded_conv``,
planned by its ``banded_prep``). When the plan covers every present
neighbour (``WindowPlan.covers``), this is ``banded_conv`` exactly.

Rows are sorted with z fastest, so the k3 offsets of one dx (a cluster)
read one narrow band of rows for a block of consecutive output rows.
``window_plan`` gives each (128-row block, cluster) the start and length of
that band. The TPU plan's 32-row alignment and single 4,096-row union
window were Mosaic's constraints and are not carried over. The kernel is
``banded_conv``'s (``csrc/common.cuh``: wgmma on mbarrier rings, the
weights cast once into their swizzled image) with the windows read from
the plan: each 256-row CTA copies its two blocks' windows into shared
memory and gathers from there by row address;
``tools/probe_banded_kernel.py`` in the port runs it beside
``banded_conv``.

CPU tensors take ``banded_window_conv_reference``; CUDA tensors launch the
kernel or raise (also when a window does not fit in shared memory).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from agile3d_torch.ops import cuda_build
from agile3d_torch.ops.banded_conv import (
    _check,
    banded_conv_reference,
    conv_cinp,
    conv_tile_n,
    weight_image_numel,
)
from agile3d_torch.sparse.kernel_maps import kernel_offsets

_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_M = 128  # output rows per plan block: half a CTA's (csrc BM / 2)
SMEM_MAX = 232448  # shared memory one block may use on the H100 (227 KB)
# csrc/common.cuh: window row stride (64 channels + 16 bytes), weight ring
# stages, window slots, ints per cluster of a CTA's planned windows
LDW, RING, WIN_SLOTS, PLAN_DESC = 144, 4, 2, 10


class WindowPlan(NamedTuple):
    """Per (block of ``block_m`` output rows, offset cluster): the window
    rows [start, start + length) of the input. Tensors are int32."""

    start: torch.Tensor    # [nb, ncl]
    length: torch.Tensor   # [nb, ncl]
    cluster: torch.Tensor  # [k] cluster of each offset
    order: torch.Tensor    # [k] offsets grouped by cluster
    bounds: torch.Tensor   # [ncl + 1] cluster c is order[bounds[c]:bounds[c+1]]
    block_m: int
    max_length: int
    covers: bool           # every present neighbour lies in its window

    def to(self, device) -> "WindowPlan":
        return self._replace(**{f: getattr(self, f).to(device) for f in
                                ("start", "length", "cluster", "order",
                                 "bounds")})


def offset_clusters(k: int) -> np.ndarray:
    """Cluster of each of the k offsets of a cubic kernel: the rank of its
    dx in ``kernel_offsets`` (rows differ by whole x-planes across dx)."""
    s = round(k ** (1 / 3))
    if s ** 3 != k:
        raise ValueError(f"{k} offsets is not a cubic kernel")
    _, cluster = np.unique(kernel_offsets(s)[:, 0], return_inverse=True)
    return cluster.reshape(-1)


def window_plan(k3, block_m: int = BLOCK_M,
                max_rows: int | None = None) -> WindowPlan:
    """Host plan (numpy) of the windowed conv over the map k3 [N, K] (-1
    absent): each window spans its block's present neighbours in the
    cluster, from the least; ``max_rows`` caps the length (then a
    neighbour past the cap lies outside, and ``covers`` is False)."""
    k3 = np.asarray(k3.cpu() if isinstance(k3, torch.Tensor) else k3)
    n, k = k3.shape
    cluster = offset_clusters(k)
    ncl = int(cluster.max()) + 1
    nb = -(-n // block_m)
    cells = np.full((nb * block_m, k), -1, np.int64)
    cells[:n] = k3
    cells = cells.reshape(nb, block_m, k)
    start = np.zeros((nb, ncl), np.int64)
    length = np.zeros((nb, ncl), np.int64)
    for c in range(ncl):
        sel = cells[:, :, cluster == c].reshape(nb, -1)
        lo = np.where(sel >= 0, sel, np.iinfo(np.int64).max).min(axis=1)
        hi = sel.max(axis=1)
        live = hi >= 0
        start[:, c] = np.where(live, lo, 0)
        length[:, c] = np.where(live, hi - lo + 1, 0)
    if max_rows is not None:
        length = np.minimum(length, max_rows)
    rel = cells - start[:, cluster][:, None, :]
    inside = (rel >= 0) & (rel < length[:, cluster][:, None, :])
    order = np.argsort(cluster, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(cluster))])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return WindowPlan(i32(start), i32(length), i32(cluster), i32(order),
                      i32(bounds), block_m, int(length.max(initial=0)),
                      bool(np.all(inside | (cells < 0))))


def window_mask(k3: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
    """[N, K] bool: the neighbour is present and inside its window."""
    blk = torch.arange(k3.shape[0], device=k3.device) // plan.block_m
    cl = plan.cluster.long()
    rel = k3 - plan.start[blk][:, cl]
    return (k3 >= 0) & (rel >= 0) & (rel < plan.length[blk][:, cl])


def window_stats(k3, plan: WindowPlan) -> dict:
    """Window lengths per cluster over the windows that hold a neighbour
    (p50, p99, max), rows copied into windows against rows a gather of
    every present neighbour reads, and the neighbours inside."""
    k3 = torch.as_tensor(k3).cpu()
    plan = plan.to("cpu")
    length = plan.length.numpy()
    per = []
    for c in range(length.shape[1]):
        live = length[:, c][length[:, c] > 0]
        per.append({"p50": float(np.percentile(live, 50)) if live.size else 0.0,
                    "p99": float(np.percentile(live, 99)) if live.size else 0.0,
                    "max": int(live.max(initial=0))})
    present = int((k3 >= 0).sum())
    return {"blocks": int(length.shape[0]), "windows": per,
            "window_rows": int(length.sum()), "present": present,
            "inside": int(window_mask(k3, plan).sum()),
            "row_ratio": present / max(int(length.sum()), 1),
            "covers": plan.covers}


def banded_window_conv_reference(x: torch.Tensor, k3: torch.Tensor,
                                 plan: WindowPlan,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the map with every neighbour
    outside its window set to -1, through ``banded_conv_reference``."""
    return banded_conv_reference(x, torch.where(window_mask(k3, plan), k3, -1),
                                 w)


def window_work(k3: torch.Tensor, plan: WindowPlan, cin: int,
                cout: int) -> tuple[float, float]:
    """(operations, bytes) of the function: 2 cin cout products per
    neighbour inside its window; x, the map, w and the plan arrays the
    kernel reads (start, length, order, bounds) read once, f32 and int32;
    y written once."""
    n, k = k3.shape
    nb, ncl = plan.start.shape
    flops = 2.0 * float(window_mask(k3, plan).sum()) * cin * cout
    nbytes = 4.0 * (n * cin + n * k + k * cin * cout + n * cout
                    + 2 * nb * ncl + k + ncl + 1)
    return flops, nbytes


def _win_rows(k: int, cout: int, staged: bool, slots: int) -> int:
    """Rows each of ``slots`` window slots holds beside the weight ring,
    the barriers, the windows' descriptors with the plan's order and
    bounds, and (``staged``) the CTA's 256 rows of indices (csrc
    ``win_rows``; a zero row follows them)."""
    ncl = int(offset_clusters(k).max()) + 1
    fixed = (1024 + RING * conv_tile_n(cout) * 128 + (2 * RING + 2 * WIN_SLOTS) * 8
             + (PLAN_DESC * ncl + k + ncl + 1) * 4  # windows, order, bounds
             + (2 * BLOCK_M * k * 4 if staged else 0))
    return (SMEM_MAX - fixed) // (slots * LDW) - 1


def window_layout(k: int, cout: int, max_length: int) -> tuple[int, bool, int]:
    """(window slots, indices staged, rows a slot holds) of the launch for
    a plan whose longest window is ``max_length``: the most slots, then
    staged indices, such that a slot holds the windows of a CTA's two
    blocks (csrc ``agile3d_banded_window``). Raises ValueError when even
    one slot cannot."""
    for slots in (WIN_SLOTS, 1):
        for staged in (True, False):
            rows = _win_rows(k, cout, staged, slots)
            if 2 * max_length <= rows:
                return slots, staged, rows
    raise ValueError(f"two windows of {max_length} rows do not fit one slot")


def max_window_rows(k: int, cout: int) -> int:
    """The longest window the kernel takes at k offsets and cout output
    channels: one slot holds a CTA's two windows of it. A window row is one
    64-channel slice of x, so the input width does not enter."""
    return _win_rows(k, cout, False, 1) // 2


def _lib():
    lib = cuda_build.load("banded_window")
    fn = lib.agile3d_banded_window
    fn.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def banded_window_conv(x: torch.Tensor, k3: torch.Tensor, plan: WindowPlan,
                       w: torch.Tensor) -> torch.Tensor:
    """Windowed banded k3 conv. x [N, cin] f32, k3 [N, K] int32 (-1
    absent), plan from ``window_plan(k3)`` on x's device, w [K, cin, cout]
    f32 -> [N, cout] f32."""
    if x.device.type == "cpu":
        return banded_window_conv_reference(x, k3, plan, w)
    _check(x, k3, w)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32, got {x.dtype}, {w.dtype}")
    n, cin = x.shape
    k, _, cout = w.shape
    arrays = (plan.start, plan.length, plan.order, plan.bounds)
    if not all(a.device == x.device and a.dtype == torch.int32
               and a.is_contiguous() for a in arrays):
        raise ValueError("the plan's tensors must be int32, contiguous, on "
                         "x's device (WindowPlan.to)")
    if plan.block_m != BLOCK_M or plan.start.shape[0] != -(-n // BLOCK_M) \
            or plan.order.shape[0] != k:
        raise ValueError(f"the plan (block_m {plan.block_m}, "
                         f"{plan.start.shape[0]} blocks, {plan.order.shape[0]} "
                         f"offsets) is not one of this map's")
    limit = max_window_rows(k, cout)
    if plan.max_length > limit:
        raise ValueError(f"a window of {plan.max_length} rows exceeds the "
                         f"{limit} that fit in shared memory at cout {cout}")
    cinp = conv_cinp(cin)
    y = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    xb = torch.empty((n, cinp), dtype=torch.bfloat16, device=x.device)
    wimg = torch.empty(weight_image_numel(k, cin, cout), dtype=torch.bfloat16,
                       device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k3.data_ptr(), w.data_ptr(),
                plan.start.data_ptr(), plan.length.data_ptr(),
                plan.order.data_ptr(), plan.bounds.data_ptr(), y.data_ptr(),
                xb.data_ptr(), wimg.data_ptr(), n, k, plan.bounds.shape[0] - 1,
                cin, cinp, cout, plan.max_length, stream)
    if rc != 0:
        raise RuntimeError(f"banded_window kernel launch failed: CUDA error {rc}")
    banded_window_conv.launches += 1
    return y


banded_window_conv.launches = 0
