"""The port's probes (``agile3d_torch/tools``) and their kernels' plain
versions against the TPU probes they replace, run on the CPU: the VMEM row
gather of ``tools/probe_vmem_gather.py`` and the windowed banded conv of
``tools/probe_banded_kernel.py``, both through the Pallas interpreter.

On CPU tensors the wrappers must take the plain versions (the kernels
themselves are checked on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_torch.data.synthetic import make_scene, write_benchmark
from agile3d_torch.ops.banded_conv import banded_conv_reference
from agile3d_torch.ops.banded_window import (
    banded_window_conv,
    banded_window_conv_reference,
    max_window_rows,
    offset_clusters,
    window_mask,
    window_plan,
    window_layout,
    window_stats,
    window_work,
)
from agile3d_torch.ops.row_gather import (
    CLUSTER,
    SLICE_MAX,
    TABLE_MAX,
    gather_work,
    row_gather_reference,
    slice_bytes,
    smem_row_gather,
)
from agile3d_torch.sparse.kernel_maps import build_pyramid, kernel_offsets
from agile3d_torch.sparse.quantize import sparse_quantize
from agile3d_torch.tools import probe_banded_kernel, probe_smem_gather
from tools.probe_banded_kernel import BLOCK_M, banded_prep, make_banded_conv
from tools.probe_vmem_gather import gather_kernel, gather_kernel_ta

torch.set_num_threads(1)


@pytest.mark.parametrize("form", ["take", "take_along_axis"])
def test_row_gather_plain_matches_pallas_gather(form):
    """Both lowering forms of the TPU probe's VMEM gather give x[idx]
    exactly, and so does the port's plain version."""
    rng = np.random.default_rng(0)
    x = rng.random((256, 128), np.float32)
    idx = rng.integers(0, 256, (512,)).astype(np.int32)
    if form == "take":
        kernel, jidx = gather_kernel, jnp.asarray(idx)
        idx_space = pltpu.SMEM
    else:
        kernel, jidx = gather_kernel_ta, jnp.asarray(idx[:, None])
        idx_space = pltpu.VMEM
    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((512, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=idx_space),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jidx, jnp.asarray(x)))

    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    got = row_gather_reference(xt, it).numpy()
    np.testing.assert_array_equal(got, ref)
    launches = smem_row_gather.launches
    np.testing.assert_array_equal(smem_row_gather(xt, it).numpy(), got)
    assert smem_row_gather.launches == launches


def _map_1024():
    """A seeded 1,024-row map: the first 1,000 sorted voxels of a small
    scene, then 24 pad rows (-1)."""
    coords, _, _ = make_scene(np.random.default_rng(0), n_points=4000,
                              num_obj=2, extent=2.0)
    vox, _, _ = sparse_quantize(coords, 0.05)
    k3 = build_pyramid(vox[:1000]).levels[0].k3
    return np.concatenate([k3, np.full((24, 27), -1, np.int32)])


def test_window_plain_matches_jax_probe_kernel():
    """The plain window conv against the TPU probe's kernel (interpret
    mode), each side planned by its own host plan; both round the operands
    to bf16 and sum in f32."""
    k3 = _map_1024()
    n, cin, cout = k3.shape[0], 96, 96
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, cin)).astype(np.float32)
    x[1000:] = 0.0
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)

    w0, lo, sub_ws, ok = banded_prep(k3, n)
    assert ok
    nbr_pad = np.full((n, lo.shape[1]), -1, np.int32)
    nbr_pad[:, :27] = k3
    nbr_aug = np.hstack([nbr_pad, np.repeat(lo // 32, BLOCK_M, axis=0)])
    conv = make_banded_conv(n, 27, cin, cout, sub_ws=sub_ws, interpret=True)
    ref = np.asarray(conv(jnp.asarray(x), jnp.asarray(nbr_aug),
                          jnp.asarray(w0 // 32), jnp.asarray(w)))

    plan = window_plan(k3)
    assert plan.covers
    xt, k3t, wt = (torch.from_numpy(a) for a in (x, k3, w))
    got = banded_window_conv_reference(xt, k3t, plan, wt).numpy()
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * (float(np.abs(ref).max()) + 1.0), err
    assert np.abs(got[1000:]).max() == 0.0
    launches = banded_window_conv.launches
    np.testing.assert_array_equal(
        banded_window_conv(xt, k3t, plan, wt).numpy(), got)
    assert banded_window_conv.launches == launches


@pytest.fixture(scope="module")
def scene_pyramid(tmp_path_factory):
    """A small write_benchmark scene through the port's host prep."""
    cfg = Config()
    scans, lst = write_benchmark(str(tmp_path_factory.mktemp("probe")),
                                 num_scenes=1, num_obj=3, seed=4,
                                 n_points=30000, extent=3.0)
    ds = InterMultiObjDataset(scans, lst, cfg.model.voxel_size)
    return collate_scenes([ds[0]], cfg.buckets).pyramid


@pytest.mark.parametrize("level", [0, 1])
def test_window_plan_covers_scene_and_equals_banded_conv(scene_pyramid,
                                                         level):
    lv = scene_pyramid.levels[level]
    k3 = torch.from_numpy(lv.k3)
    plan = window_plan(lv.k3, max_rows=max_window_rows(27, 96))
    assert plan.covers and plan.max_length > 0
    n = k3.shape[0]
    assert plan.start.shape == (-(-n // 128), 3)
    stats = window_stats(lv.k3, plan)
    assert stats["inside"] == stats["present"] == int((k3 >= 0).sum())
    assert stats["window_rows"] < stats["present"]
    g = torch.Generator().manual_seed(level)
    x = torch.randn(n, 96, generator=g)
    x[lv.num_valid:] = 0.0
    w = torch.randn(27, 96, 64, generator=g) * 0.05
    got = banded_window_conv_reference(x, k3, plan, w)
    assert torch.equal(got, banded_conv_reference(x, k3, w))
    assert float(got[lv.num_valid:].abs().max()) == 0.0


def test_neighbour_outside_its_window_is_dropped(scene_pyramid):
    """Move one neighbour just past its window's cap: the plan no longer
    covers the map, and the plain version drops exactly that term."""
    k3 = scene_pyramid.levels[0].k3.copy()
    cap = window_plan(k3).max_length
    plan = window_plan(k3, max_rows=cap)
    assert plan.covers
    cluster = offset_clusters(27)
    b, c = plan.start.shape[0] // 2, 1
    lo = int(plan.start[b, c])
    cells = k3[b * 128:(b + 1) * 128][:, cluster == c]
    hi = int(cells.max())
    assert hi > lo and lo + cap < scene_pyramid.levels[0].num_valid
    i, jj = np.argwhere(cells == hi)[0]
    j = int(np.flatnonzero(cluster == c)[jj])
    row = b * 128 + int(i)
    k3[row, j] = lo + cap  # one past the longest window the cap allows

    moved = window_plan(k3, max_rows=cap)
    assert not moved.covers
    assert int(moved.start[b, c]) == lo and int(moved.length[b, c]) == cap
    k3t = torch.from_numpy(k3)
    mask = window_mask(k3t, moved)
    assert int(((k3t >= 0) & ~mask).sum()) == 1 and not bool(mask[row, j])
    g = torch.Generator().manual_seed(5)
    x = torch.randn(k3.shape[0], 32, generator=g)
    w = torch.randn(27, 32, 16, generator=g)
    dropped = k3t.clone()
    dropped[row, j] = -1
    got = banded_window_conv_reference(x, k3t, moved, w)
    assert torch.equal(got, banded_conv_reference(x, dropped, w))
    assert not torch.equal(got[row], banded_conv_reference(x, k3t, w)[row])


def test_offset_clusters_follow_dx():
    """Three clusters of nine offsets, one per dx of kernel_offsets(3)
    (offsets 0-8, 9-17, 18-26); the plan lists them in that order."""
    cluster = offset_clusters(27)
    np.testing.assert_array_equal(cluster, np.repeat([0, 1, 2], 9))
    np.testing.assert_array_equal(cluster, kernel_offsets(3)[:, 0] + 1)
    plan = window_plan(np.full((130, 27), -1, np.int32))
    assert plan.bounds.tolist() == [0, 9, 18, 27]
    assert plan.order.tolist() == list(range(27))
    assert plan.max_length == 0 and plan.covers
    with pytest.raises(ValueError):
        offset_clusters(26)


def test_bound_helpers_count_work():
    """window_work: 2 cin cout products per neighbour inside its window,
    and x, the map, w, the plan's kernel arrays and y once; gather_work:
    the table, the indices and the output once, no products."""
    k3 = torch.full((512, 27), -1, dtype=torch.int32)
    k3[:100, :5] = 7          # block 0, cluster 0: inside
    k3[200, 20] = 250         # block 1, cluster 2
    k3[201, 20] = 250 + 40    # past a 10-row cap
    plan = window_plan(k3, max_rows=10)
    assert not plan.covers
    flops, nbytes = window_work(k3, plan, 96, 64)
    assert flops == 2.0 * (500 + 1) * 96 * 64
    assert nbytes == 4.0 * (512 * 96 + 512 * 27 + 27 * 96 * 64 + 512 * 64
                            + 2 * 4 * 3 + 27 + 3 + 1)
    assert gather_work(384, 128, 27648) == (
        0.0, 4.0 * (384 * 128 + 27648 * 128) + 4.0 * 27648)
    assert gather_work(10, 96, 30, itemsize=2) == (
        0.0, 2.0 * (10 * 96 + 30 * 96) + 4.0 * 30)


def test_row_gather_slice_sizes():
    """Mirrors of csrc/row_gather.cu: each CTA of a 16-CTA cluster holds
    ceil(W / 16) rows behind a 16-byte mbarrier in its 227 KB (the TPU
    probe's 4,096-row table 128 KB each, the 384-row table 12 KB); the
    wrapper refuses a table beyond the cluster's shared memory on the card
    and names the limit, while the CPU takes the plain version."""
    assert CLUSTER == 16
    assert SLICE_MAX == 232448 - 16 and TABLE_MAX == 16 * SLICE_MAX == 3718912
    assert slice_bytes(384, 128) == 24 * 512
    assert slice_bytes(4096, 128) == 131072
    assert slice_bytes(1, 4) == 16 and slice_bytes(17, 4) == 32
    assert slice_bytes(7248, 128) == 231936 <= SLICE_MAX  # 453 rows a CTA
    assert slice_bytes(7249, 128) == 232448 > SLICE_MAX   # 454 rows a CTA
    assert slice_bytes(8192, 128) > SLICE_MAX
    x = torch.zeros(8192, 128)
    idx = torch.tensor([0, 8191], dtype=torch.int32)
    assert torch.equal(smem_row_gather(x, idx), x[[0, 8191]])
    # the bound: 2 MB of table, the indices and the 14 MB output once
    _, nbytes = gather_work(4096, 128, 27648)
    assert nbytes == 2097152 + 27648 * 512 + 110592


def test_max_window_rows_fills_shared_memory():
    """One window slot holds a CTA's two windows of the longest length and
    a zero row, beside the weight ring (4 stages of bn x 128 bytes), 12
    barriers, the three clusters' descriptors and the plan's order and
    bounds: 631 rows at cout 96, 574 at cout 128 (a window row is one
    64-channel slice, whatever the input width)."""
    for cout, bn, rows in ((96, 96, 631), (128, 128, 574)):
        assert max_window_rows(27, cout) == rows
        desc = (3 * 10 + 27 + 4) * 4
        used = 1024 + 4 * bn * 128 + 12 * 8 + desc + (2 * rows + 1) * 144
        assert used <= 232448 < used + 2 * 144


def test_window_layout_takes_two_slots_where_they_fit():
    """The smoke scene's plan (longest window 199 rows) takes two slots
    and staged indices; the probe scene's (556) one slot without them."""
    assert window_layout(27, 96, 199) == (2, True, 534)
    assert window_layout(27, 96, 556) == (1, False, 1262)
    assert window_layout(27, 96, 631)[0] == 1
    with pytest.raises(ValueError):
        window_layout(27, 96, 632)


@pytest.mark.parametrize("level", [0, 1])
def test_max_window_rows_cover_scene_windows(scene_pyramid, level):
    """At the eval shapes (96 -> 96, 128 -> 96) the kernel takes the
    longest window of the scene's maps, so its plan still covers."""
    k3 = scene_pyramid.levels[level].k3
    limit = max_window_rows(27, 96)
    assert limit >= window_plan(k3).max_length
    assert window_plan(k3, max_rows=limit).covers


def test_probe_entry_points_run_on_cpu(capsys):
    banded = probe_banded_kernel.main(["--device", "cpu", "--points", "3000"])
    assert banded["covers"] and banded["max_abs_err"] == 0.0
    assert banded["bound_ms"] > 0 and banded["device"].startswith("cpu")
    gather = probe_smem_gather.main(["--device", "cpu", "--points", "3000"])
    assert gather["a_equal"] and gather["a2_equal"]
    assert set(gather) >= {"a_kernel", "a_plain", "a_library", "a2_kernel",
                           "b", "c", "d"}
    out = capsys.readouterr().out
    assert "covers every present neighbour: True" in out
    assert "window kernel" in out and "banded_conv" in out
    for tag in ("(a)", "(a2)", "(b)", "(c)", "(d)"):
        assert f"{tag} " in out
    assert "M rows/s" in out and "H100 bound" in out


@pytest.mark.parametrize("probe", [probe_banded_kernel, probe_smem_gather])
def test_probes_default_to_the_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
