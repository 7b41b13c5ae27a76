"""Boundary distances of the query rows: a hand-written CUDA kernel for
Hopper (``csrc/boundary_dist.cu``) and its plain PyTorch version.

    d[b, i] = min over valid j with cluster[b, j] != cluster[b, i] of
              ||coords[b, i] - coords[b, j]||   (inf where no j qualifies)

for every row i with ``query[b, i]`` (every row when ``query`` is None);
the other rows hold +inf. The device click rollouts
(``engine/device_eval.py``, ``engine/device_train.py``) call it once per
round with the error rows as the query, so that no round waits on the host
for them; the device eval also calls it once for a scene's round 0 (every
object row queried), whose ranking runs on the host. The host loops keep
their plain distance (``engine/clicks.py::boundary_distances``). It
stands in for the XLA fusion of the JAX package's
``engine/device_eval.py::_boundary_distances_all``, not for a Pallas
kernel. The squared distance is summed per axis, ``((0 + dx dx) + dy dy) +
dz dz`` in float32 (the |x|^2 - 2xy + |y|^2 form cancels catastrophically);
the kernel equals the plain version bit for bit, because the next click is
the first row that attains the largest distance.

The kernel skips tiles of keys whose box lies provably no nearer than the
minima it already holds (``box_lower_bound`` is the bound's plain twin),
so it evaluates a data-dependent share of the pairs; ``pairs`` counts them.
The culling relies on rows sorted by packed (batch, x, y, z) key, the
order ``build_pyramid`` enforces; rows in another order give the same
bits but cull nearly nothing.

CPU tensors take ``boundary_distances_all_reference``; CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from agile3d_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's tiling (csrc/boundary_dist.cu): one key record a lane in a
# tile, one query row a lane, WARPS query groups of 32 rows a CTA
TILE, WARPS = 32, 4
SCAN_CHUNK = 1024  # rows per CTA of the count and compaction passes
# pair distances the plain version holds at once: rows * N <= this
_CHUNK_ELEMS = 1 << 26


@torch.no_grad()
def boundary_distances_all_reference(coords: torch.Tensor,
                                     cluster: torch.Tensor,
                                     valid: torch.Tensor,
                                     query: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version: per batch item, chunks of the query rows
    against every key, the squared distance summed per axis, excluded pairs
    set to inf, the min over keys, then the square root, correctly rounded
    (taken in float64: PyTorch's float32 sqrt on the CPU can miss by one
    ulp); +inf on the rows outside ``query``."""
    b, n, _ = coords.shape
    rows = max(1, min(n, _CHUNK_ELEMS // max(n, 1)))
    inf = torch.tensor(float("inf"), dtype=coords.dtype, device=coords.device)
    out = torch.full((b, n), float("inf"), dtype=coords.dtype,
                     device=coords.device)
    for i in range(b):
        c, cl, ok = coords[i], cluster[i], valid[i]
        idx = (torch.arange(n, device=coords.device) if query is None
               else torch.nonzero(query[i]).reshape(-1))
        for s in range(0, len(idx), rows):
            sel = idx[s:s + rows]
            rc, rcl = c[sel], cl[sel]
            d2 = torch.zeros((len(rc), n), dtype=coords.dtype,
                             device=coords.device)
            for ax in range(3):
                diff = rc[:, ax][:, None] - c[:, ax][None, :]
                d2 = d2 + diff * diff
            excl = (rcl[:, None] == cl[None, :]) | ~ok[None, :]
            out[i, sel] = torch.where(excl, inf, d2).amin(dim=1)
    return torch.sqrt(torch.clamp(out, min=0.0).double()).float()


def box_lower_bound(q_lo: torch.Tensor, q_hi: torch.Tensor,
                    k_lo: torch.Tensor, k_hi: torch.Tensor) -> torch.Tensor:
    """The kernel's culling bound, in plain PyTorch: the squared gap
    between boxes [q_lo, q_hi] and [k_lo, k_hi] ([..., 3] float32), per
    axis max(0, q_lo - k_hi, k_lo - q_hi), summed as a pair's d^2 is, each
    operation rounded as written. Round-to-nearest is monotone, so this is
    <= the computed d^2 of every pair of points of the two boxes."""
    zero = torch.zeros((), dtype=q_lo.dtype)
    gap = torch.maximum(zero, torch.maximum(q_lo - k_hi, k_lo - q_hi))
    sq = gap * gap
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def distance_work(cluster: torch.Tensor, valid: torch.Tensor,
                  query: torch.Tensor | None = None) -> tuple[float, float]:
    """(operations, bytes) that a call on these inputs needs at the least:
    one pair a query row, 8 FP32 operations (3 differences, 3 products, 2
    sums); coords, cluster ids, valid flags (and the query mask) read once,
    d written once."""
    b, n = cluster.shape
    rows = b * n if query is None else int(query.sum())
    nbytes = b * n * (12 + 4 + 1 + 4 + (0 if query is None else 1))
    return 8.0 * rows, float(nbytes)


def all_pairs(valid: torch.Tensor, query: torch.Tensor | None = None) -> int:
    """The (query row, valid key) pairs of an all-pairs evaluation: per
    item, query rows times valid rows."""
    keys = valid.sum(dim=1).long()
    rows = (torch.full_like(keys, valid.shape[1]) if query is None
            else query.sum(dim=1).long())
    return int((rows * keys).sum())


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the entries of a library built from ``csrc/boundary_dist.cu``
    (this checkout's or another's) and returns it."""
    fn = lib.agile3d_boundary_dist
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P]
    fn.restype = _I
    lib.agile3d_boundary_dist_scratch.argtypes = [_I, _I]
    lib.agile3d_boundary_dist_scratch.restype = ctypes.c_int64
    return lib


def launch(lib: ctypes.CDLL, coords: torch.Tensor, cluster: torch.Tensor,
           valid: torch.Tensor, query: torch.Tensor | None = None,
           pairs: torch.Tensor | None = None) -> torch.Tensor:
    """One call of a ``bind``-declared library's kernel on CUDA inputs of
    the wrapper's types and shapes, on the current stream (no checks, no
    count); raises when the launch fails."""
    b, n = cluster.shape
    out = torch.empty((b, n), dtype=torch.float32, device=coords.device)
    scratch = torch.empty(lib.agile3d_boundary_dist_scratch(b, n),
                          dtype=torch.uint8, device=coords.device)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.agile3d_boundary_dist(
            coords.data_ptr(), cluster.data_ptr(), valid.data_ptr(),
            None if query is None else query.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), b, n,
            None if pairs is None else pairs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"boundary_distances_all kernel launch failed: "
                           f"CUDA error {rc}")
    return out


def _lib():
    return bind(cuda_build.load("boundary_dist"))


def boundary_distances_all(coords: torch.Tensor, cluster: torch.Tensor,
                           valid: torch.Tensor,
                           query: torch.Tensor | None = None,
                           pairs: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """coords [B, N, 3] f32, cluster [B, N] int32, valid [B, N] bool, query
    [B, N] bool or None (every row) -> d [B, N] f32, +inf outside query.
    ``pairs``: a CUDA int64 tensor of one element that the kernel adds the
    (query, key) pairs it evaluated to (card only)."""
    if coords.device.type == "cpu":
        if pairs is not None:
            raise ValueError("pairs counts the kernel's work: card only")
        return boundary_distances_all_reference(coords, cluster, valid, query)
    masks = (valid,) if query is None else (valid, query)
    if not (coords.is_cuda and cluster.device == coords.device
            and all(m.device == coords.device for m in masks)):
        raise ValueError("coords, cluster, valid and query must be on one "
                         "CUDA device")
    if (coords.dtype != torch.float32 or cluster.dtype != torch.int32
            or any(m.dtype != torch.bool for m in masks)):
        raise TypeError(f"coords must be float32, cluster int32, valid and "
                        f"query bool, got {coords.dtype}, {cluster.dtype}, "
                        f"{[m.dtype for m in masks]}")
    if (coords.dim() != 3 or coords.shape[2] != 3
            or cluster.shape != coords.shape[:2]
            or any(m.shape != coords.shape[:2] for m in masks)):
        raise ValueError(f"bad shapes {tuple(coords.shape)}, "
                         f"{tuple(cluster.shape)}, "
                         f"{[tuple(m.shape) for m in masks]}")
    if not (coords.is_contiguous() and cluster.is_contiguous()
            and all(m.is_contiguous() for m in masks)):
        raise ValueError("coords, cluster, valid and query must be "
                         "contiguous")
    if pairs is not None and not (pairs.device == coords.device
                                  and pairs.dtype == torch.int64
                                  and pairs.numel() == 1):
        raise ValueError("pairs must be one int64 element on coords' device")
    b, n = cluster.shape
    if b > 65535 or n >= 2 ** 31:
        raise ValueError(f"{b} items of {n} rows: the grid takes at most "
                         f"65,535 items of fewer than 2**31 rows")
    if n == 0 or b == 0:
        return torch.empty((b, n), dtype=torch.float32, device=coords.device)
    out = launch(_lib(), coords, cluster, valid, query, pairs)
    boundary_distances_all.launches += 1
    return out


boundary_distances_all.launches = 0
