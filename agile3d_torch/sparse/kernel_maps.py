"""Kernel maps: the coordinate pyramid and its gather maps, built on the host
in numpy (the port's own copy of the JAX package's ``sparse/kernel_maps.py``).

  * ``k3`` [N_l, 27]: row of the neighbor at each 3x3x3 offset, -1 absent.
  * ``k5`` [N_0, 125]: the same for the 5x5x5 stem, finest level only.
  * ``down`` [N_{l+1}, 8]: the fine rows at 2*g + {0,1}^3 of coarse voxel g.
  * ``up_parent`` / ``up_offset`` [N_l]: the coarse parent floor(g/2) of
    each fine voxel and the kernel element (interleaved bits of g mod 2).

Grid coordinates are g_l = coordinate / 2^l, so g_{l+1} = floor(g_l / 2).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from agile3d_torch.sparse.quantize import pack_coords


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Offsets [K, 3] for a cubic kernel in itertools.product order (last
    axis fastest). Odd sizes are centred, even sizes span [0, k)."""
    if kernel_size % 2 == 1:
        r = (kernel_size - 1) // 2
        rng = range(-r, r + 1)
    else:
        rng = range(0, kernel_size)
    return np.array(list(itertools.product(rng, rng, rng)), dtype=np.int32)


KERNEL_OFFSETS_CACHE = {k: kernel_offsets(k) for k in (2, 3, 5)}


def me_kernel_perm(kernel_size: int) -> np.ndarray:
    """Permutation from MinkowskiEngine's kernel-slice order (first axis
    fastest) to ``kernel_offsets`` order: ``ours[i] = me_kernel[perm[i]]``.
    The two enumerations are digit reversals of each other."""
    offs = kernel_offsets(kernel_size)
    ix = offs - offs.min(axis=0)
    k = kernel_size
    return (ix[:, 0] + ix[:, 1] * k + ix[:, 2] * k * k).astype(np.int64)


# kernel volume -> permutation, read by the weight bridge (utils/ckpt.py)
ME_KERNEL_PERM = {k ** 3: me_kernel_perm(k) for k in (2, 3, 5)}


@dataclasses.dataclass
class LevelMaps:
    """One pyramid level (stride 2^level)."""

    grid: np.ndarray              # int32 [N, 3]
    batch: np.ndarray             # int32 [N]
    k3: np.ndarray                # int32 [N, 27]
    k5: np.ndarray | None         # int32 [N, 125], finest level only
    # maps to the next (coarser) level; None at the coarsest level
    down: np.ndarray | None       # int32 [N_coarse, 8]
    up_parent: np.ndarray | None  # int32 [N]
    up_offset: np.ndarray | None  # int32 [N] kernel element in [0, 8)

    @property
    def num_voxels(self) -> int:
        return self.grid.shape[0]


@dataclasses.dataclass
class Pyramid:
    levels: list[LevelMaps]   # levels[0] = stride 1 (finest)


def _neighbor_map(grid: np.ndarray, batch: np.ndarray,
                  offsets: np.ndarray) -> np.ndarray:
    keys = pack_coords(grid, batch)
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    out = np.empty((grid.shape[0], offsets.shape[0]), dtype=np.int32)
    for j in range(offsets.shape[0]):
        q = pack_coords(grid + offsets[j][None, :], batch)
        pos = np.minimum(np.searchsorted(keys_sorted, q), keys_sorted.size - 1)
        out[:, j] = np.where(keys_sorted[pos] == q, order[pos], -1)
    return out


def build_pyramid(
    voxel_coords: np.ndarray,
    batch: np.ndarray | None = None,
    num_levels: int = 5,
    stem_kernel: int = 5,
) -> Pyramid:
    """Build the UNet coordinate pyramid and its gather maps.

    ``voxel_coords`` [N, 3] must be sorted by packed (batch, x, y, z) key and
    unique, as ``sparse_quantize`` emits them; every coarser level keeps that
    order.
    """
    grid = np.ascontiguousarray(voxel_coords, dtype=np.int32)
    if batch is None:
        batch = np.zeros(grid.shape[0], dtype=np.int32)
    batch = batch.astype(np.int32)
    keys0 = pack_coords(grid, batch)
    if grid.shape[0] > 1 and not (np.diff(keys0) > 0).all():
        raise ValueError(
            "build_pyramid: voxel rows must be sorted by packed "
            "(batch,x,y,z) key (z fastest) and unique")

    # (g mod 2) -> kernel-2 element, consistent with kernel_offsets(2)
    k2_weight = np.array([4, 2, 1], dtype=np.int32)
    levels: list[LevelMaps] = []
    for lvl in range(num_levels):
        k3 = _neighbor_map(grid, batch, KERNEL_OFFSETS_CACHE[3])
        k5 = None
        if lvl == 0 and stem_kernel != 3:
            k5 = _neighbor_map(grid, batch, KERNEL_OFFSETS_CACHE[stem_kernel])
        levels.append(LevelMaps(grid=grid, batch=batch, k3=k3, k5=k5,
                                down=None, up_parent=None, up_offset=None))
        if lvl == num_levels - 1:
            break

        coarse_of_fine = grid >> 1            # floor(g/2), negatives too
        ckeys = pack_coords(coarse_of_fine, batch)
        # np.unique sorts, so the coarse level keeps the sorted-row order
        _, first_idx, parent = np.unique(ckeys, return_index=True,
                                         return_inverse=True)
        parent = parent.reshape(-1).astype(np.int32)
        coarse_grid = coarse_of_fine[first_idx]
        coarse_batch = batch[first_idx]
        down = np.full((coarse_grid.shape[0], 8), -1, dtype=np.int32)
        child_offset = ((grid & 1) * k2_weight[None, :]).sum(axis=1)
        down[parent, child_offset] = np.arange(grid.shape[0], dtype=np.int32)

        levels[-1].down = down
        levels[-1].up_parent = parent
        levels[-1].up_offset = child_offset.astype(np.int32)
        grid, batch = coarse_grid, coarse_batch

    return Pyramid(levels=levels)
