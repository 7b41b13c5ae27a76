"""Boundary distances of every row: a hand-written CUDA kernel for Hopper
(``csrc/boundary_dist.cu``) and its plain PyTorch version.

    d[b, i] = min over valid j with cluster[b, j] != cluster[b, i] of
              ||coords[b, i] - coords[b, j]||   (inf where no j qualifies)

The device click rollout (``engine/device_eval.py``,
``engine/device_train.py``) calls it once per round, for all rows, so that
no round waits on the host for the error rows. It stands in for the XLA
fusion of the JAX package's ``engine/device_eval.py::
_boundary_distances_all``, not for a Pallas kernel. The squared distance
is summed per axis, ``((0 + dx dx) + dy dy) + dz dz`` in float32 (the
|x|^2 - 2xy + |y|^2 form cancels catastrophically); the kernel equals the
plain version bit for bit, because the next click is the first row that
attains the largest distance.

CPU tensors take ``boundary_distances_all_reference``; CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from agile3d_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's tiling (csrc/boundary_dist.cu)
THREADS, QUERIES_PER_THREAD, TILE, KEY_CHUNK = 256, 4, 512, 2048
QUERY_BLOCK = THREADS * QUERIES_PER_THREAD
TILE_SMEM_BYTES = 2 * TILE * 16  # two 512-record tiles of {x, y, z, cluster}
# pair distances the plain version holds at once: rows * N <= this
_CHUNK_ELEMS = 1 << 26


@torch.no_grad()
def boundary_distances_all_reference(coords: torch.Tensor,
                                     cluster: torch.Tensor,
                                     valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per batch item, chunks of query rows against
    every key, the squared distance summed per axis, excluded pairs set to
    inf, the min over keys, then the square root, correctly rounded (taken
    in float64: PyTorch's float32 sqrt on the CPU can miss by one ulp)."""
    b, n, _ = coords.shape
    rows = max(1, min(n, _CHUNK_ELEMS // max(n, 1)))
    inf = torch.tensor(float("inf"), dtype=coords.dtype, device=coords.device)
    out = torch.empty((b, n), dtype=coords.dtype, device=coords.device)
    for i in range(b):
        c, cl, ok = coords[i], cluster[i], valid[i]
        for s in range(0, n, rows):
            rc, rcl = c[s:s + rows], cl[s:s + rows]
            d2 = torch.zeros((len(rc), n), dtype=coords.dtype,
                             device=coords.device)
            for ax in range(3):
                diff = rc[:, ax][:, None] - c[:, ax][None, :]
                d2 = d2 + diff * diff
            excl = (rcl[:, None] == cl[None, :]) | ~ok[None, :]
            out[i, s:s + rows] = torch.where(excl, inf, d2).amin(dim=1)
    return torch.sqrt(torch.clamp(out, min=0.0).double()).float()


def distance_work(cluster: torch.Tensor,
                  valid: torch.Tensor) -> tuple[float, float]:
    """(operations, bytes) that a call on these inputs needs: 8 FP32
    operations (3 differences, 3 products, 2 sums) for each pair of a row
    and a valid key of its item in another cluster (pairs within one
    cluster need no distance); coords, cluster ids and valid flags read
    once, d written once."""
    b, n = cluster.shape
    pairs = 0
    for i in range(b):
        ids, inv = torch.unique(cluster[i], return_inverse=True)
        rows = torch.bincount(inv, minlength=len(ids))
        keys = torch.bincount(inv[valid[i]], minlength=len(ids))
        pairs += n * int(valid[i].sum()) - int((rows * keys).sum())
    return 8.0 * pairs, float(b * n * (12 + 4 + 1 + 4))


def _lib():
    lib = cuda_build.load("boundary_dist")
    fn = lib.agile3d_boundary_dist
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


def boundary_distances_all(coords: torch.Tensor, cluster: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """coords [B, N, 3] f32, cluster [B, N] int32, valid [B, N] bool ->
    d [B, N] f32."""
    if coords.device.type == "cpu":
        return boundary_distances_all_reference(coords, cluster, valid)
    if not (coords.is_cuda and cluster.device == coords.device
            and valid.device == coords.device):
        raise ValueError("coords, cluster and valid must be on one CUDA device")
    if (coords.dtype != torch.float32 or cluster.dtype != torch.int32
            or valid.dtype != torch.bool):
        raise TypeError(f"coords must be float32, cluster int32 and valid "
                        f"bool, got {coords.dtype}, {cluster.dtype}, "
                        f"{valid.dtype}")
    if (coords.dim() != 3 or coords.shape[2] != 3
            or cluster.shape != coords.shape[:2]
            or valid.shape != coords.shape[:2]):
        raise ValueError(f"bad shapes {tuple(coords.shape)}, "
                         f"{tuple(cluster.shape)}, {tuple(valid.shape)}")
    if not (coords.is_contiguous() and cluster.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("coords, cluster and valid must be contiguous")
    b, n = cluster.shape
    if b > 65535 or n >= 2 ** 31:
        raise ValueError(f"{b} items of {n} rows: the grid takes at most "
                         f"65,535 items of fewer than 2**31 rows")
    out = torch.empty((b, n), dtype=torch.float32, device=coords.device)
    if n == 0 or b == 0:
        return out
    keys = torch.empty((b, n, 4), dtype=torch.float32, device=coords.device)
    count = torch.zeros(b, dtype=torch.int32, device=coords.device)
    fn = _lib()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(coords.data_ptr(), cluster.data_ptr(), valid.data_ptr(),
                keys.data_ptr(), count.data_ptr(), out.data_ptr(), b, n,
                stream)
    if rc != 0:
        raise RuntimeError(f"boundary_distances_all kernel launch failed: "
                           f"CUDA error {rc}")
    boundary_distances_all.launches += 1
    return out


boundary_distances_all.launches = 0
