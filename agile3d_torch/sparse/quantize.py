"""Voxel quantization (the port's own copy of the JAX package's host prep).

Voxel order is sorted by packed (batch, x, y, z) key, z fastest, so the
occupied cells of any z-column are consecutive rows and every gather map
built on top is monotone per kernel offset. ``unique_map`` picks each
voxel's first point in point order.

The division runs in float64, as the JAX package's default C++ path does
(``sparse/csrc/sparse_index.cpp``, ``std::floor(float / double)``); a
float32 division puts a few boundary points into different voxels.
"""

from __future__ import annotations

import numpy as np

# 19 bits per spatial coordinate (signed range +-2^18), 6 bits batch.
_COORD_BITS = 19
_COORD_OFFSET = 1 << (_COORD_BITS - 1)
_COORD_MAX = (1 << _COORD_BITS) - 1
# Guard band so adding a small kernel offset never carries into the next
# bit field.
_MARGIN = 4


def pack_coords(coords: np.ndarray, batch: np.ndarray | None = None) -> np.ndarray:
    """Pack int coords [N,3] (+ optional batch ids [N]) into int64 keys.
    Raises ValueError outside +-(2^18 - 4)."""
    c = coords.astype(np.int64) + _COORD_OFFSET
    if c.size and (c.min() < _MARGIN or c.max() > _COORD_MAX - _MARGIN):
        raise ValueError(
            f"coordinates out of packable range "
            f"+-{_COORD_OFFSET - _MARGIN}: [{coords.min()}, {coords.max()}]"
        )
    key = (c[:, 0] << (2 * _COORD_BITS)) | (c[:, 1] << _COORD_BITS) | c[:, 2]
    if batch is not None:
        key = key | (batch.astype(np.int64) << (3 * _COORD_BITS))
    return key


def sparse_quantize(
    coords: np.ndarray, quantization_size: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize float points [N, 3] to voxels.

    Returns (voxel_coords int32 [M, 3], unique_map int64 [M],
    inverse_map int64 [N]) with ``voxel_coords == floor(coords / q)
    [unique_map]`` and ``inverse_map[i]`` the voxel row of point i.
    """
    q = float(quantization_size)
    vox = np.floor(np.asarray(coords).astype(np.float64) / q).astype(np.int32)
    keys = pack_coords(vox)
    # np.unique sorts the keys and reports each key's first occurrence
    _, first_idx, inverse_map = np.unique(keys, return_index=True,
                                          return_inverse=True)
    return (vox[first_idx], first_idx.astype(np.int64),
            inverse_map.reshape(-1).astype(np.int64))
