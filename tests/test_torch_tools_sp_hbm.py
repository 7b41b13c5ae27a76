"""The port's per-rank memory tool for the voxel-sharded backbone
(``agile3d_torch/tools/measure_sp_hbm.py``) against the repository's JAX
tool (``tools/measure_sp_hbm.py``) on the CPU.

The host side equals JAX's: at ``--points 60000 --extent 6 --sp 2`` the
voxels, the padded rows and the level-0 halo rows (the padded halo that
the JAX tool prints, and the live rows in it) come out of the JAX tool's
code path and the port's tool alike; the full-size scene's 2,157,228
voxels pad to the same 2,162,688-row bucket in both packages. The tool
itself runs on the CPU with two spawned ``gloo`` ranks: it prints the JAX
tool's lines, its memory fields are null (no allocator to read), and the
two ranks' scene features, gathered back, equal the one-process pass
within the sharded backbone's bounds (``mask_feat`` 2e-4, ``pos_pcd``
1e-5, cmin / cmax 1e-6, as ``tests/test_torch_parallel_backbone.py`` holds
the sharded backbone to JAX's)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from agile3d_torch.tools import measure_sp_hbm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--points", "60000", "--extent", "6", "--sp", "2", "--device", "cpu"]
FULL_VOXELS = 2_157_228     # make_scene(default_rng(0), 4M, 10, 60 m) + noise
FULL_ROWS = 2_162_688

torch.set_num_threads(2)


def _jax_host_side(points: int, extent: float, sp: int):
    """``tools/measure_sp_hbm.py``'s scene, collation and partition: (voxels,
    padded rows, the printed level-0 halo, its live rows)."""
    from agile3d_tpu.config import DEFAULT_VOXEL_BUCKETS, Config
    from agile3d_tpu.data.datasets import SceneSample, collate_scenes
    from agile3d_tpu.data.synthetic import make_scene
    from agile3d_tpu.parallel.sp_backbone import partition_pyramid
    from agile3d_tpu.sparse.quantize import sparse_quantize

    cfg = Config(buckets=tuple(DEFAULT_VOXEL_BUCKETS) + (1572864, 2097152))
    rng = np.random.default_rng(0)
    coords, colors, labels = make_scene(rng, n_points=points, num_obj=10,
                                        extent=extent)
    coords += rng.standard_normal(coords.shape).astype(np.float32) * 0.04
    vox, umap, imap = sparse_quantize(coords, cfg.model.voxel_size)
    sample = SceneSample(
        vox_coords=vox, raw_coords=coords[umap],
        feats=colors[umap].astype(np.float32) / 255.0,
        labels=labels[umap].astype(np.int32),
        labels_full=labels.astype(np.int32), inverse_map=imap,
        click_idx={}, scene_name="hbm", num_obj=10)
    batch = collate_scenes([sample], cfg.buckets)
    n_pad = batch.pyramid.levels[0].grid.shape[0]
    sp_pyr = partition_pyramid(batch.pyramid, sp)
    halo = sp_pyr.levels[0].halo_src
    return len(vox), n_pad, halo.reshape(sp, -1).shape[1], int((halo >= 0).sum())


@pytest.fixture(scope="module")
def tool_run():
    lines = []
    res = measure_sp_hbm.run(measure_sp_hbm.get_args_parser().parse_args(ARGV),
                             log=lines.append, compare=True)
    return res, lines


def test_host_side_matches_jax(tool_run):
    res, _ = tool_run
    voxels, rows, h0, live = _jax_host_side(60000, 6.0, 2)
    assert (res["voxels"], res["rows"]) == (voxels, rows) == (47185, 49152)
    assert (res["halo0_rows"], res["halo0_live"]) == (h0, live)
    assert res["halo0_share"] == h0 / rows
    assert res["sp_ranks"]["rows"] == [rows // 2] * 2
    assert res["sp_ranks"]["halo_rows"] == [h0] * 2


def test_full_scene_bucket_matches_jax():
    from agile3d_torch.config import bucket_size
    from agile3d_torch.tools.stress_kitti import STRESS_BUCKETS
    from agile3d_tpu.config import DEFAULT_VOXEL_BUCKETS
    from agile3d_tpu.config import bucket_size as jax_bucket_size

    jax_ladder = tuple(DEFAULT_VOXEL_BUCKETS) + (1572864, 2097152)
    assert measure_sp_hbm.stress_config().buckets == STRESS_BUCKETS
    assert tuple(STRESS_BUCKETS) == jax_ladder
    assert bucket_size(FULL_VOXELS, STRESS_BUCKETS) == FULL_ROWS
    assert jax_bucket_size(FULL_VOXELS, jax_ladder) == FULL_ROWS
    # past the ladder's last rung: the bucket extends, divisible by 8 ranks
    assert FULL_ROWS > 2097152 and FULL_ROWS % 8 == 0


def test_prints_the_jax_lines_and_null_memory(tool_run):
    res, lines = tool_run
    assert lines[0].startswith("scene: 47185 voxels (padded 49152); "
                               "host prep ")
    assert lines[1].startswith("single-process backbone: not measured (cpu)")
    assert lines[2].startswith("partition ")
    assert f"level-0 halo {res['halo0_rows']} rows (" in lines[2]
    assert "% of N)" in lines[2]
    assert lines[3].startswith("sp=2 backbone: not measured (cpu) peak in "
                               "use per rank")
    assert lines[4] == "per-rank reduction: not measured (cpu)"
    assert lines[-1].startswith("{") and len(lines) == 6
    assert res["single"]["peak_bytes"] is None
    assert res["sp_ranks"]["peak_bytes"] == [None, None]
    assert res["sp_ranks"]["peak_bytes_max"] is None
    assert res["reduction"] is None
    assert res["device"].startswith("cpu") and res["sp_ranks"]["backend"] == "gloo"


def test_gathered_rank_features_equal_one_process(tool_run):
    res, _ = tool_run
    assert res["within_tol"]
    for name, tol in measure_sp_hbm.FEATURE_TOL.items():
        assert res["plain_max_abs_diff"][name] <= tol, name
    # the CPU takes the plain convs in both: the kernel pass is the plain one
    assert res["kernel_max_abs_diff"] == {
        "mask_feat": res["plain_max_abs_diff"]["mask_feat"]}
    assert res["mask_feat_scale"] > 0


def test_no_kernel_launch_on_the_cpu(tool_run):
    res, _ = tool_run
    assert set(res["single"]["launches"].values()) == {0}
    assert set(res["sp_ranks"]["launches"].values()) == {0}
    assert res["single"]["wall_s"] > 0
    assert all(t > 0 for t in res["sp_ranks"]["forward_wall_s"])


def test_needs_two_ranks_and_a_card():
    with pytest.raises(SystemExit):
        measure_sp_hbm.main(["--sp", "1", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure_sp_hbm.main(["--points", "2000"])


def test_new_tools_import_no_jax():
    code = ("import sys; import agile3d_torch.tools.measure_sp_hbm, "
            "agile3d_torch.tools.bench_dp_scaling; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'agile3d_tpu'))]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
