"""Voxel quantization (the port's own copy of the JAX package's host prep).

Voxel order is sorted by packed (batch, x, y, z) key, z fastest, so the
occupied cells of any z-column are consecutive rows and every gather map
built on top is monotone per kernel offset. ``unique_map`` picks each
voxel's first point in point order.

The division runs in float64, as the JAX package's default C++ path does
(``sparse/csrc/sparse_index.cpp``, ``std::floor(float / double)``); a
float32 division puts a few boundary points into different voxels.

``sparse_quantize`` runs the port's native runtime (``sparse/native.py``)
unless ``AGILE3D_NATIVE=0``; the numpy path gives the same arrays for
float32 points. The native path, like the JAX package's, takes the points
as float32 (float64 points are rounded to float32 first).
"""

from __future__ import annotations

import threading

import numpy as np

from agile3d_torch.sparse import native

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
    if native.enabled():
        _count("native")
        return native.quantize(coords, q)
    _count("numpy")
    vox = np.floor(np.asarray(coords).astype(np.float64) / q).astype(np.int32)
    keys = pack_coords(vox)
    # np.unique sorts the keys and reports each key's first occurrence
    _, first_idx, inverse_map = np.unique(keys, return_index=True,
                                          return_inverse=True)
    return (vox[first_idx], first_idx.astype(np.int64),
            inverse_map.reshape(-1).astype(np.int64))


# calls by path, for a run to show which one its host prep took
sparse_quantize.paths = {"native": 0, "numpy": 0}
_paths_lock = threading.Lock()


def _count(path: str) -> None:
    with _paths_lock:
        sparse_quantize.paths[path] += 1
