"""The oversize guard of the port against the JAX package's: the padding
ladder, the memory pre-check and its one-line CLI error, raised before any
backbone work."""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from agile3d_torch.cli import run
from agile3d_torch.config import DEFAULT_VOXEL_BUCKETS, bucket_size
from agile3d_torch.engine.eval import (
    SceneTooLargeError,
    check_single_chip_rows,
)
from agile3d_torch.utils.costs import SINGLE_CHIP_HBM_GIB, eval_hbm_gib
from agile3d_tpu import config as jcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = (32, 64, 128, 224)


@pytest.mark.parametrize("ladder", ["voxels", "rounds"])
def test_bucket_size_equals_jax(ladder):
    if ladder == "voxels":
        buckets = DEFAULT_VOXEL_BUCKETS
        ns = (1, 2048, 2049, 200_000, 786_432, 1_048_576, 1_048_577,
              1_203_878, 5_000_000)
        assert buckets == jcfg.DEFAULT_VOXEL_BUCKETS
    else:
        buckets = ROUNDS
        ns = (1, 32, 33, 224, 225, 449, 1000)
    for n in ns:
        assert bucket_size(n, buckets) == jcfg.bucket_size(n, buckets), n


def test_guard_raises_under_the_override(monkeypatch):
    monkeypatch.setenv("AGILE3D_HBM_GIB", "1.0")
    with pytest.raises(SceneTooLargeError) as exc:
        check_single_chip_rows(1_204_224)
    msg = str(exc.value)
    assert msg.startswith("scene pads to 1204224 voxel rows")
    for remedy in ("crop", "voxel size", "--sp"):
        assert remedy in msg
    check_single_chip_rows(65_536)  # under the budget: no-op


def test_default_budget_passes_scannet_and_kitti_buckets(monkeypatch):
    monkeypatch.delenv("AGILE3D_HBM_GIB", raising=False)
    for rows in (196_608, 786_432, 1_048_576):
        check_single_chip_rows(rows)
    beyond = int(2 * SINGLE_CHIP_HBM_GIB * 2**30 / (eval_hbm_gib(1) * 2**30))
    with pytest.raises(SceneTooLargeError):
        check_single_chip_rows(beyond)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    from agile3d_torch.data.synthetic import write_benchmark

    root = str(tmp_path_factory.mktemp("oversize"))
    return write_benchmark(root, num_scenes=1, num_obj=2, seed=0,
                           n_points=3000)


def test_cli_exits_with_one_line_before_any_backbone_work(
        small_scene, tmp_path, monkeypatch):
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.models.agile3d import Agile3D

    def no_backbone(*args, **kwargs):
        raise AssertionError("the backbone ran past the guard")

    monkeypatch.setattr(Agile3D, "forward_backbone", no_backbone)
    monkeypatch.setenv("AGILE3D_HBM_GIB", "0.01")
    scans, val_list = small_scene
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        run(eval_multi_obj.get_args_parser(), eval_multi_obj.main,
            ["--scan_folder", scans, "--val_list", val_list, "--device",
             "cpu", "--output_dir", str(tmp_path)])
    assert exc.value.code == 1
    lines = err.getvalue().strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(
        "error: scene pads to 4096 voxel rows"), lines


def test_entry_point_prints_no_traceback(small_scene, tmp_path):
    scans, val_list = small_scene
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["AGILE3D_HBM_GIB"] = "0.01"
    proc = subprocess.run(
        [sys.executable, "-m", "agile3d_torch.eval_multi_obj",
         "--scan_folder", scans, "--val_list", val_list, "--device", "cpu",
         "--output_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 1
    assert "Traceback" not in proc.stderr, proc.stderr[-2000:]
    assert proc.stderr.strip().splitlines()[-1].startswith(
        "error: scene pads to"), proc.stderr[-2000:]
