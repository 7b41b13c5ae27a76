"""The port's native host runtime (``agile3d_torch/sparse/native.py``,
``sparse/csrc/sparse_index.cpp``) against the port's numpy path and the
JAX package's native path, on the CPU.

Every comparison is exact: the three paths must give the same voxels,
maps and pyramids bit for bit."""

import os
import subprocess
import sys

import numpy as np
import pytest

from agile3d_torch.data.synthetic import make_scene
from agile3d_torch.sparse import native
from agile3d_torch.sparse.kernel_maps import (
    KERNEL_OFFSETS_CACHE,
    _neighbor_map,
    _stride_down,
    build_pyramid,
)
from agile3d_torch.sparse.quantize import pack_coords, sparse_quantize
from agile3d_tpu.sparse import build_pyramid as jax_build_pyramid
from agile3d_tpu.sparse.native import (
    native_neighbor_map,
    native_quantize,
    native_stride_down,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL_FIELDS = ("grid", "batch", "k3", "k5", "down", "up_parent", "up_offset")


def _scene(n_points, num_obj, extent, seed, shift=0.0, noise=0.03):
    rng = np.random.default_rng(seed)
    coords, _, _ = make_scene(rng, n_points=n_points, num_obj=num_obj,
                              extent=extent)
    coords = coords + rng.standard_normal(coords.shape).astype(np.float32) \
        * noise
    return (coords + np.float32(shift)).astype(np.float32)


def _same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _numpy_path(fn, *args):
    with native.disabled():
        return fn(*args)


def _batched(vox_list):
    """Items side by side, sorted by packed (batch, x, y, z) key, as
    collate_scenes builds them."""
    vox = np.vstack(vox_list)
    batch = np.repeat(np.arange(len(vox_list), dtype=np.int32),
                      [len(v) for v in vox_list])
    order = np.argsort(pack_coords(vox, batch), kind="stable")
    return vox[order], batch[order]


@pytest.mark.parametrize("shift", [0.0, -3.7])  # negative coordinates too
def test_quantize_equals_numpy_and_jax(shift):
    coords = _scene(20000, 4, 5.0, seed=3, shift=shift)
    got = sparse_quantize(coords, 0.05)
    want = _numpy_path(sparse_quantize, coords, 0.05)
    jax = native_quantize(coords, 0.05)
    assert jax is not None
    for g, w, j, name in zip(got, want, jax, ("vox", "unique", "inverse")):
        _same(g, w, name)
        _same(g, j, name)
    if shift < 0:
        assert (got[0] < 0).any()


@pytest.mark.parametrize("items,shift", [(1, 0.0), (3, 0.0), (2, -5.1)])
def test_neighbor_maps_and_stride_equal_numpy_and_jax(items, shift):
    vox, batch = _batched([sparse_quantize(_scene(6000, 3, 3.0, seed=s,
                                                  shift=shift), 0.05)[0]
                           for s in range(items)])
    for k in (3, 5):
        offs = KERNEL_OFFSETS_CACHE[k]
        got = native.neighbor_map(vox, batch, offs)
        _same(got, _neighbor_map(vox, batch, offs), f"k{k}")
        _same(got, native_neighbor_map(vox, batch, offs), f"k{k} jax")
        assert (got >= 0).any() and (got == -1).any()
    got = native.stride_down(vox, batch)
    for g, w, j, name in zip(got, _stride_down(vox, batch),
                             native_stride_down(vox, batch),
                             ("grid", "batch", "parent", "child", "down")):
        _same(g, w, name)
        _same(g, j, name + " jax")


def test_unsorted_rows_take_the_sorting_co_scan():
    vox = sparse_quantize(_scene(3000, 2, 2.0, seed=9), 0.05)[0]
    perm = np.random.default_rng(0).permutation(len(vox))
    batch = np.zeros(len(vox), np.int32)
    offs = KERNEL_OFFSETS_CACHE[3]
    _same(native.neighbor_map(vox[perm], batch, offs),
          _neighbor_map(vox[perm], batch, offs), "k3 unsorted")


@pytest.mark.parametrize("items", [1, 4])
def test_whole_pyramid_equals_numpy_and_jax(items):
    vox, batch = _batched([sparse_quantize(_scene(5000, 3, 3.0, seed=s,
                                                  shift=-1.0), 0.05)[0]
                           for s in range(items)])
    before = dict(build_pyramid.paths)
    pyr = build_pyramid(vox, batch)
    assert build_pyramid.paths["native"] == before["native"] + 1
    npyr = _numpy_path(build_pyramid, vox, batch)
    assert build_pyramid.paths["numpy"] == before["numpy"] + 1
    jpyr = jax_build_pyramid(vox, batch)
    assert len(pyr.levels) == len(npyr.levels) == len(jpyr.levels) == 5
    for i, (lv, nlv, jlv) in enumerate(zip(pyr.levels, npyr.levels,
                                           jpyr.levels)):
        for f in LEVEL_FIELDS:
            _same(getattr(lv, f), getattr(nlv, f), f"level {i} {f}")
            _same(getattr(lv, f), getattr(jlv, f), f"level {i} {f} jax")


def test_bench_scene_keeps_the_native_voxel_count():
    """ROADMAP C1: the 400k-point bench scene quantizes to 185,590 voxels
    on both of the port's paths (the JAX package's numpy fallback, dividing
    in float32, gives 185,591)."""
    coords = _scene(400000, 8, 8.0, seed=0)
    before = dict(sparse_quantize.paths)
    got = sparse_quantize(coords, 0.05)
    assert sparse_quantize.paths["native"] == before["native"] + 1
    assert len(got[0]) == 185590
    want = _numpy_path(sparse_quantize, coords, 0.05)
    assert sparse_quantize.paths["numpy"] == before["numpy"] + 1
    for g, w, name in zip(got, want, ("vox", "unique", "inverse")):
        _same(g, w, name)


def test_switched_off_the_library_is_not_touched(monkeypatch):
    """AGILE3D_NATIVE=0: the numpy path, as before, without loading or
    building the library."""
    def refuse():
        raise AssertionError("the native library was asked for")

    monkeypatch.setattr(native, "get_lib", refuse)
    monkeypatch.setenv("AGILE3D_NATIVE", "0")
    assert not native.enabled()
    coords = _scene(3000, 2, 2.0, seed=4)
    before = (dict(sparse_quantize.paths), dict(build_pyramid.paths))
    vox = sparse_quantize(coords, 0.05)[0]
    build_pyramid(vox)
    assert sparse_quantize.paths["numpy"] == before[0]["numpy"] + 1
    assert sparse_quantize.paths["native"] == before[0]["native"]
    assert build_pyramid.paths["numpy"] == before[1]["numpy"] + 1
    assert build_pyramid.paths["native"] == before[1]["native"]
    with native.disabled():
        assert os.environ["AGILE3D_NATIVE"] == "0"
    assert os.environ["AGILE3D_NATIVE"] == "0"


def test_out_of_range_coordinates_raise():
    with pytest.raises(ValueError):
        sparse_quantize(np.array([[262144 * 0.05, 0, 0]], np.float32), 0.05)
    with pytest.raises(ValueError):
        native.neighbor_map(np.array([[262143, 0, 0]], np.int32),
                            np.zeros(1, np.int32), KERNEL_OFFSETS_CACHE[3])


_BUILD = """
import sys
from agile3d_torch.sparse import native
native.BUILD_DIR = sys.argv[1]
native.LIBRARY = sys.argv[1] + "/libsparse_index.so"
print(native.build())
"""


def test_first_use_builds_once_under_concurrent_starts(tmp_path):
    """Four processes asking for the library at once (pytest's workers at
    a first run): one compiles, the others wait on the lock and find it
    built; no half-written file is left."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert sorted(o.strip() for o, _ in outs) == ["False"] * 3 + ["True"]
    names = sorted(os.listdir(tmp_path))
    assert names == ["libsparse_index.so", "sparse_index.lock"]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIBRARY",
                        str(tmp_path / "build" / "libsparse_index.so"))
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert os.listdir(tmp_path / "build") == ["sparse_index.lock"]
