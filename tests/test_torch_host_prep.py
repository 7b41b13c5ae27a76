"""The port's host prep (quantize, build_pyramid, pad_pyramid) against the
JAX package's, field by field."""

import numpy as np
import pytest
import torch

from agile3d_tpu.sparse import build_pyramid as jax_build_pyramid
from agile3d_tpu.sparse import pad_pyramid as jax_pad_pyramid
from agile3d_tpu.sparse.native import native_quantize
from agile3d_tpu.sparse.quantize import sparse_quantize as jax_sparse_quantize
from agile3d_torch.config import DEFAULT_VOXEL_BUCKETS, bucket_size
from agile3d_torch.data.synthetic import make_scene
from agile3d_torch.sparse.grid import pad_pyramid, to_device
from agile3d_torch.sparse.kernel_maps import build_pyramid
from agile3d_torch.sparse.quantize import pack_coords, sparse_quantize

torch.set_num_threads(1)

LEVEL_FIELDS = ("grid", "batch", "k3", "k5", "down", "up_parent", "up_offset")
PADDED_FIELDS = LEVEL_FIELDS + ("valid", "num_valid")


def _scene(n_points, num_obj, extent, seed, noise=0.03):
    rng = np.random.default_rng(seed)
    coords, _, _ = make_scene(rng, n_points=n_points, num_obj=num_obj,
                              extent=extent)
    return coords + rng.standard_normal(coords.shape).astype(np.float32) * noise


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("batched", [False, True])
def test_pyramid_matches_jax_field_by_field(batched):
    coords = _scene(6000, 3, 4.0, seed=1)
    vox, umap, imap = sparse_quantize(coords, 0.05)
    jvox, jumap, jimap = jax_sparse_quantize(coords, 0.05)
    _assert_same(vox, jvox, "voxels")
    _assert_same(umap, jumap, "unique_map")
    _assert_same(imap, jimap, "inverse_map")

    batch = None
    if batched:   # two scenes side by side, as collate_scenes builds them
        half = len(vox) // 2
        batch = np.repeat(np.arange(2, dtype=np.int32), [half, len(vox) - half])
        order = np.argsort(pack_coords(vox, batch), kind="stable")
        vox, batch = vox[order], batch[order]
    pyr = build_pyramid(vox, batch)
    jpyr = jax_build_pyramid(vox, batch)
    assert len(pyr.levels) == len(jpyr.levels) == 5
    for i, (lv, jlv) in enumerate(zip(pyr.levels, jpyr.levels)):
        for f in LEVEL_FIELDS:
            _assert_same(getattr(lv, f), getattr(jlv, f), f"level {i} {f}")

    buckets = (512, 2048, 4096)
    pp = pad_pyramid(pyr, buckets)
    jpp = jax_pad_pyramid(jpyr, buckets, stem_banded=False)
    for i, (lv, jlv) in enumerate(zip(pp.levels, jpp.levels)):
        for f in PADDED_FIELDS:
            _assert_same(getattr(lv, f), getattr(jlv, f), f"padded {i} {f}")
        assert lv.grid.shape[0] == bucket_size(lv.num_valid, buckets)

    dev = to_device(pp, "cpu")
    for lv, dlv in zip(pp.levels, dev.levels):
        assert dlv.num_valid == lv.num_valid
        assert dlv.k3.dtype == torch.int32 and dlv.valid.dtype == torch.bool
        np.testing.assert_array_equal(dlv.k3.numpy(), lv.k3)


def test_bench_scene_quantizes_like_native_path():
    """Regression: the 400k-point bench scene. The port divides in float64
    like the JAX package's default C++ path (185,590 voxels); a float32
    division puts 2 boundary points into other voxels (185,591)."""
    coords = _scene(400000, 8, 8.0, seed=0)
    vox, umap, imap = sparse_quantize(coords, 0.05)
    assert len(vox) == 185590
    assert bucket_size(len(vox), DEFAULT_VOXEL_BUCKETS) == 196608
    native = native_quantize(coords, 0.05)
    if native is not None:
        for got, want, name in zip((vox, umap, imap), native,
                                   ("voxels", "unique_map", "inverse_map")):
            _assert_same(got, want, name)


def test_pack_coords_range():
    with pytest.raises(ValueError):
        pack_coords(np.array([[262144, 0, 0]], np.int32))
    sparse_quantize(np.array([[-1.0, 2.5, 3.0]], np.float32), 0.05)


@pytest.mark.parametrize("binary", [True, False])
def test_read_ply_reads_the_jax_writers_files(tmp_path, binary):
    """Binary and ascii scans, with mesh faces after the vertices; the
    port's writer gives the same bytes as the JAX package's."""
    from agile3d_torch.data.ply import read_ply, write_ply
    from agile3d_tpu.data.ply import write_ply as jax_write_ply

    rng = np.random.default_rng(0)
    n = 50
    fields = {
        "x": rng.random(n).astype(np.float32),
        "y": rng.random(n).astype(np.float32),
        "z": rng.random(n).astype(np.float32),
        "R": rng.integers(0, 255, n).astype(np.uint8),
        "G": rng.integers(0, 255, n).astype(np.uint8),
        "B": rng.integers(0, 255, n).astype(np.uint8),
        "label": rng.integers(0, 10, n).astype(np.int32),
    }
    path = str(tmp_path / "mesh.ply")
    jax_write_ply(path, fields, faces=rng.integers(0, n, (7, 3)).astype(np.int32),
                  binary=binary)
    back = read_ply(path)
    assert list(back) == list(fields)
    for k, v in fields.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6)
    if binary:
        ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        write_ply(ours, fields)
        jax_write_ply(theirs, fields)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
