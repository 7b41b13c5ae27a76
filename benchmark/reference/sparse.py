"""Voxels and the coordinate pyramid of the plain reference, in torch on any
device. Written from the semantics the program documents, not from its
code: a point falls in voxel floor(x / q) (the division in float64), a
voxel is represented by its first point, rows are sorted by the packed
(batch, x, y, z) key with z fastest, a coarser level holds floor(g / 2)
of the finer one, and a conv reads the rows at the kernel's offsets in
``itertools.product`` order (last axis fastest; odd kernels centred, the
kernel of 2 spanning {0, 1}).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

_BITS = 19
_OFF = 1 << (_BITS - 1)


def kernel_offsets(k: int, device) -> torch.Tensor:
    r = range(-(k // 2), k // 2 + 1) if k % 2 else range(k)
    return torch.tensor(list(itertools.product(r, r, r)), dtype=torch.int64,
                        device=device)


def pack(grid: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (batch, x, y, z) with z fastest."""
    c = grid.long() + _OFF
    return ((batch.long() << (3 * _BITS)) | (c[:, 0] << (2 * _BITS))
            | (c[:, 1] << _BITS) | c[:, 2])


class Voxels(NamedTuple):
    grid: torch.Tensor      # int64 [M, 3], sorted by key
    first: torch.Tensor     # int64 [M] first point of each voxel
    inverse: torch.Tensor   # int64 [N] voxel of each point


def voxelize(points: torch.Tensor, q: float) -> Voxels:
    """points float32 [N, 3] (min-shifted) -> voxels."""
    g = torch.floor(points.double() / q).long()
    keys = pack(g, torch.zeros(len(g), dtype=torch.int64, device=g.device))
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    n = len(points)
    first = torch.full((len(uniq),), n, dtype=torch.int64, device=g.device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=g.device),
                          "amin")
    return Voxels(g[first], first, inverse)


class Level(NamedTuple):
    grid: torch.Tensor       # int64 [N, 3]
    batch: torch.Tensor      # int64 [N]
    k3: torch.Tensor         # int64 [N, 27], -1 absent
    k5: torch.Tensor | None  # int64 [N, 125] at level 0
    down: torch.Tensor | None       # [N_coarse, 8] rows of this level
    parent: torch.Tensor | None     # [N] row of the coarser level
    child: torch.Tensor | None      # [N] kernel-2 element in [0, 8)


def neighbours(grid, batch, offsets) -> torch.Tensor:
    keys = pack(grid, batch)          # sorted
    out = torch.empty((len(grid), len(offsets)), dtype=torch.int64,
                      device=grid.device)
    for j, o in enumerate(offsets):
        q = pack(grid + o, batch)
        pos = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
        out[:, j] = torch.where(keys[pos] == q, pos, -1)
    return out


def pyramid(grid: torch.Tensor, batch: torch.Tensor, levels: int = 5,
            stem: int = 5) -> list[Level]:
    """grid / batch sorted by key (a concatenation of samples in batch
    order, each sorted)."""
    dev = grid.device
    out = []
    for lvl in range(levels):
        k3 = neighbours(grid, batch, kernel_offsets(3, dev))
        k5 = neighbours(grid, batch, kernel_offsets(stem, dev)) if lvl == 0 \
            else None
        if lvl == levels - 1:
            out.append(Level(grid, batch, k3, k5, None, None, None))
            break
        coarse = torch.div(grid, 2, rounding_mode="floor")
        ckeys = pack(coarse, batch)
        uniq, parent = torch.unique(ckeys, sorted=True, return_inverse=True)
        n = len(grid)
        first = torch.full((len(uniq),), n, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, parent, torch.arange(n, device=dev), "amin")
        child = ((grid - 2 * coarse) * torch.tensor([4, 2, 1], device=dev)
                 ).sum(1)
        down = torch.full((len(uniq), 8), -1, dtype=torch.int64, device=dev)
        down[parent, child] = torch.arange(n, device=dev)
        out.append(Level(grid, batch, k3, k5, down, parent, child))
        grid, batch = coarse[first], batch[first]
    return out
