"""The backbone with the voxel axis sharded over the mesh's ``sp`` axis
(counterpart of the JAX package's ``parallel/sp_backbone.py``), for scenes
whose UNet does not fit one card.

  * Rows are split into ``n_sp`` contiguous blocks of each padded level.
    The rows are sorted by packed (batch, x, y, z) key, so a block is a slab
    in x and the neighbours across a block's edge lie in a thin layer.
  * ``partition_pyramid`` (host numpy, once per scene; the JAX package's
    function bit for bit) finds, per level, the HALO: the rows that an
    output row of another rank reads through the k3 / k5 maps, the
    stride-2 down maps or the transposed conv's parent maps, padded to a
    geometric ladder of sizes (``_halo_bucket``). Every map is rewritten
    into rank-local rows: [0, L) the rank's own, [L, L + H) the halo, -1
    absent.
  * Each conv does one HALO EXCHANGE: every rank gathers the halo rows it
    owns into a zero [H, C] buffer and one ``psum`` gives every rank the
    whole halo (in f32, exact: each slot is one value plus zeros); then the
    plain gather-GEMM conv (``ops/sparse_conv.py``) runs on
    ``[x_local | halo]``.
  * Training-mode BatchNorm takes cross-rank moments: one ``psum`` each of
    the count, the sum and the sum of squares. Eval-mode BatchNorm reads
    the running statistics, rank-locally.

The convs are the plain ones, as in the JAX package's design: the halo
rows sit at [L, L + H), outside the sorted order, and the banded k3 kernel
(``ops/banded_conv.py``) and the stem kernel (``ops/banded_stem.py``) find
their windows of sorted rows from the map, so this backbone launches
neither. Single scene (B = 1) with the identity per-sample map: the case
the sharding exists for. The UNet is the one-process one:
``models/backbone.py::Res16UNet.forward`` walks it with ``RowShards``'
hooks (the exchange, the moments' ``psum``), under its dtype policy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agile3d_torch.models.agile3d import _BACKBONE_DTYPES, SceneFeatures, _where0
from agile3d_torch.ops.sparse_conv import linear, masked_gather
from agile3d_torch.parallel.mesh import Axis, axis_index, pmax, pmin, psum
from agile3d_torch.sparse.grid import PaddedPyramid


class SPLevel(NamedTuple):
    """One level remapped for an ``n_sp``-way row split. The arrays cover
    all ``n_sp * L`` rows (``local_pyramid`` cuts a rank's block); every
    map value is rank-local: [0, L) own rows, [L, L + H) halo rows, -1
    absent."""

    k3: np.ndarray                 # int32 [N, 27]
    k5: np.ndarray | None          # int32 [N, 125], finest level only
    down: np.ndarray | None        # int32 [N_next, 8] (reads THIS level)
    up_parent: np.ndarray | None   # int32 [N] (reads the NEXT level)
    up_offset: np.ndarray | None   # int32 [N]
    valid: np.ndarray              # bool [N]
    halo_src: np.ndarray           # int32 [n_sp * H]: per rank, the local
    #   row of each halo slot it owns, -1 elsewhere


class SPPyramid(NamedTuple):
    levels: tuple  # tuple[SPLevel, ...], finest first


def _halo_bucket(n: int) -> int:
    """The halo's padded size: each rung 1.5x the last, rounded up to the
    128 grain (128, 256, 384, 640, 1024, 1536, ...), so that a dataset's
    scenes share a few halo shapes."""
    h = 128
    while h < n:
        h = -(-(h * 3 // 2) // 128) * 128
    return h


def _cross_refs(map_arr: np.ndarray, l_out: int, l_in: int) -> np.ndarray:
    """The global input rows that an output row of another rank reads."""
    m = map_arr.shape[0]
    owner_out = (np.arange(m, dtype=np.int64) // l_out)[:, None]
    g = map_arr.astype(np.int64)
    mask = (g >= 0) & ((g // l_in) != owner_out)
    return np.unique(g[mask])


def _remap(map_arr: np.ndarray | None, l_out: int, l_in: int,
           halo: np.ndarray) -> np.ndarray | None:
    """Global input rows rewritten as rank-local [0, L) + halo [L, L + H)."""
    if map_arr is None:
        return None
    arr = map_arr
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[:, None]
    owner_out = (np.arange(arr.shape[0], dtype=np.int64) // l_out)[:, None]
    g = arr.astype(np.int64)
    local = (g >= 0) & ((g // l_in) == owner_out)
    out = np.where(local, g - owner_out * l_in, -1)
    remote = (g >= 0) & ~local
    if remote.any():
        pos = np.searchsorted(halo, g[remote])
        if not (halo[pos] == g[remote]).all():
            raise AssertionError("halo set incomplete")
        out[remote] = l_in + pos
    out = out.astype(np.int32)
    return out[:, 0] if squeeze else out


def partition_pyramid(ppyr: PaddedPyramid, n_sp: int) -> SPPyramid:
    """The halo sets and rank-local maps of an ``n_sp``-way split of a
    padded pyramid (host numpy, once per scene). Every level's padded size
    must divide by ``n_sp``."""
    levels = ppyr.levels
    nl = len(levels)
    sizes = [lvl.grid.shape[0] for lvl in levels]
    for n in sizes:
        if n % n_sp != 0:
            raise ValueError(
                f"padded level size {n} not divisible by n_sp={n_sp}; "
                "every bucket in config.buckets must be a multiple of the "
                "sp mesh width")
    ls = [n // n_sp for n in sizes]

    # halo[l]: the rows of level l read across a rank's edge by any map
    # that reads level-l features: its own k3 / k5, its down map (outputs
    # at l + 1), and level l - 1's transposed-conv parents
    halo_parts: list[list[np.ndarray]] = [[] for _ in range(nl)]
    for l, lvl in enumerate(levels):
        halo_parts[l].append(_cross_refs(lvl.k3, ls[l], ls[l]))
        if lvl.k5 is not None:
            halo_parts[l].append(_cross_refs(lvl.k5, ls[l], ls[l]))
        if lvl.down is not None:
            halo_parts[l].append(_cross_refs(lvl.down, ls[l + 1], ls[l]))
        if lvl.up_parent is not None and l + 1 < nl:
            halo_parts[l + 1].append(
                _cross_refs(lvl.up_parent[:, None], ls[l], ls[l + 1]))

    halos = []
    for l in range(nl):
        parts = [p for p in halo_parts[l] if p.size]
        halos.append(np.unique(np.concatenate(parts)) if parts
                     else np.empty(0, np.int64))

    out = []
    for l, lvl in enumerate(levels):
        halo = halos[l]
        h = _halo_bucket(halo.size)
        own = halo // ls[l]
        src = np.full((n_sp, h), -1, np.int64)
        shard_col = np.arange(n_sp)[:, None]
        src[:, : halo.size] = np.where(
            own[None, :] == shard_col, halo[None, :] - shard_col * ls[l], -1)

        up_parent = None
        if lvl.up_parent is not None and l + 1 < nl:
            up_parent = _remap(lvl.up_parent, ls[l], ls[l + 1], halos[l + 1])

        out.append(SPLevel(
            k3=_remap(lvl.k3, ls[l], ls[l], halo),
            k5=_remap(lvl.k5, ls[l], ls[l], halo),
            down=(_remap(lvl.down, ls[l + 1], ls[l], halo)
                  if lvl.down is not None else None),
            up_parent=up_parent,
            up_offset=lvl.up_offset if up_parent is not None else None,
            valid=lvl.valid,
            halo_src=src.reshape(-1).astype(np.int32),
        ))
    return SPPyramid(levels=tuple(out))


def local_pyramid(sp_pyr: SPPyramid, axis: Axis, device) -> tuple:
    """This rank's block of every level of ``sp_pyr`` as tensors on
    ``device`` (the ``P(axis)`` placement of the JAX package)."""
    n_sp, r = axis.size, axis_index(axis)

    def block(a):
        if a is None:
            return None
        rows = a.shape[0] // n_sp
        return torch.from_numpy(np.ascontiguousarray(
            a[r * rows:(r + 1) * rows])).to(device)

    return tuple(SPLevel(*(block(a) for a in lvl)) for lvl in sp_pyr.levels)


def _halo_exchange(x_local: torch.Tensor, halo_src: torch.Tensor,
                   axis: Axis) -> torch.Tensor:
    """[x_local | the whole halo]: each rank gives the halo rows it owns
    (zeros elsewhere) and one psum assembles them."""
    h = psum(masked_gather(x_local, halo_src), axis)
    return torch.cat([x_local, h.to(x_local.dtype)], dim=0)


class RowShards:
    """``models/backbone.py::Res16UNet.forward``'s hooks for this rank's
    block of rows: a halo exchange before every conv that reads a map, the
    cross-rank BatchNorm moments in training (one ``psum`` each of the
    count, the sum and the sum of squares; eval reads the running
    statistics, rank-locally), and the plain convs only, on autograd's
    backward under gradients: a rank's rows are followed by its halo, so
    the maps' inverses are not maps of these rows (``inverse_maps``)."""

    banded = False
    inverse_maps = False

    def __init__(self, axis: Axis):
        self.axis = axis

    def exchange(self, x, level):
        return _halo_exchange(x, level.halo_src, self.axis)

    def reduce(self, x):
        return psum(x, self.axis)


def make_forward_backbone_sp(mesh, cfg):
    """``forward_backbone_sp(model, lv, feats_l, raw_l, bn_stats=None)`` ->
    the SceneFeatures of this rank's rows (``cmin`` / ``cmax`` of the whole
    scene), the voxel-sharded ``Agile3D.forward_backbone`` of one scene
    with the identity per-sample map. ``lv``: ``local_pyramid``'s levels;
    feats_l / raw_l: this rank's rows of the level-0 features and raw
    coordinates; ``bn_stats`` (a dict) runs training-mode BatchNorm. Its
    output feeds ``parallel/sp.py`` as it is."""
    axis = mesh["sp"]

    @torch.no_grad()
    def forward_backbone_sp(model, lv, feats_l, raw_l, bn_stats=None):
        fmaps = model.backbone(
            SPPyramid(lv), feats_l, bn_stats,
            compute_dtype=_BACKBONE_DTYPES[cfg.backbone_dtype],
            rows=RowShards(axis))
        valid = lv[0].valid
        squeezed = linear(fmaps[-1].float(), model.lin_squeeze_head.kernel,
                          model.lin_squeeze_head.bias, valid=valid)
        raw_m = _where0(valid[:, None], raw_l)
        big = torch.tensor(3.4e38, dtype=raw_m.dtype, device=raw_m.device)
        cmin = pmin(torch.where(valid[:, None], raw_m, big).amin(0), axis)
        cmax = pmax(torch.where(valid[:, None], raw_m, -big).amax(0), axis)
        pos = model._pos(raw_m[None], cmin[None, None], cmax[None, None],
                         model.pos_enc.gauss_B)
        pos = _where0(valid[None, :, None], pos)
        mask_feat = squeezed[None]
        if cfg.decoder_dtype == "bfloat16":
            mask_feat = mask_feat.to(torch.bfloat16)
            pos = pos.to(torch.bfloat16)
        return SceneFeatures(mask_feat=mask_feat, pos_pcd=pos,
                             vox_valid=valid[None], raw=raw_m[None],
                             cmin=cmin[None], cmax=cmax[None])

    return forward_backbone_sp
