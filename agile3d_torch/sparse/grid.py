"""Padded pyramid: every level padded to a voxel-count bucket, with -1 maps
and zero features on pad rows.

Unlike the JAX package's ``sparse/grid.py`` there are no banded window
plans: the TPU kernels need them because Mosaic has no row gather from VMEM,
while the CUDA kernels gather rows straight from ``k3``/``k5``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from agile3d_torch.config import DEFAULT_VOXEL_BUCKETS, bucket_size
from agile3d_torch.sparse.kernel_maps import Pyramid


class PaddedLevel(NamedTuple):
    """One level padded to a bucket; maps use -1 for absent and pad. The
    array fields are numpy on the host and torch tensors after
    ``to_device``."""

    grid: np.ndarray          # int32 [Np, 3]
    batch: np.ndarray         # int32 [Np] (pad rows = -1)
    valid: np.ndarray         # bool  [Np]
    k3: np.ndarray            # int32 [Np, 27]
    k5: np.ndarray | None     # int32 [Np, 125] | None
    down: np.ndarray | None   # int32 [Np_next, 8] (rows into THIS level)
    up_parent: np.ndarray | None  # int32 [Np] (rows into the next level)
    up_offset: np.ndarray | None  # int32 [Np]
    num_valid: int            # true voxel count


class PaddedPyramid(NamedTuple):
    levels: tuple  # tuple[PaddedLevel, ...], finest first


def _pad_rows(a: np.ndarray | None, n: int, fill) -> np.ndarray | None:
    if a is None:
        return None
    pad = n - a.shape[0]
    if pad < 0:
        raise ValueError(f"bucket {n} smaller than array {a.shape[0]}")
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths, constant_values=fill)


def pad_pyramid(pyr: Pyramid,
                buckets: Sequence[int] = DEFAULT_VOXEL_BUCKETS) -> PaddedPyramid:
    sizes = [bucket_size(l.num_voxels, buckets) for l in pyr.levels]
    out = []
    for i, lvl in enumerate(pyr.levels):
        n = sizes[i]
        valid = np.zeros(n, dtype=bool)
        valid[: lvl.num_voxels] = True
        out.append(PaddedLevel(
            grid=_pad_rows(lvl.grid, n, 0),
            batch=_pad_rows(lvl.batch, n, -1),
            valid=valid,
            k3=_pad_rows(lvl.k3, n, -1),
            k5=_pad_rows(lvl.k5, n, -1),
            down=(_pad_rows(lvl.down, sizes[i + 1], -1)
                  if lvl.down is not None else None),
            up_parent=_pad_rows(lvl.up_parent, n, -1),
            up_offset=_pad_rows(lvl.up_offset, n, 0),
            num_valid=lvl.num_voxels,
        ))
    return PaddedPyramid(levels=tuple(out))


def pad_features(feats: np.ndarray, n: int) -> np.ndarray:
    """Pad per-voxel features [N, C] with zero rows to [n, C]."""
    return _pad_rows(np.asarray(feats), n, 0)


def to_device(pyr: PaddedPyramid, device) -> PaddedPyramid:
    """The same pyramid with every array as a torch tensor on ``device``
    (maps stay int32: the CUDA kernels read them as they are)."""
    def conv(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    return PaddedPyramid(levels=tuple(
        PaddedLevel(*(conv(v) if isinstance(v, np.ndarray) else v
                      for v in lvl))
        for lvl in pyr.levels))
