"""The port's parallel entry points end to end on the CPU: ``python -m
agile3d_torch.eval_multi_obj --sp 2 [--sp_backbone] --device cpu`` and
``python -m agile3d_torch.main --num_dp 2 --device cpu`` spawn their own
``gloo`` ranks, only rank 0 writes files, and the rows and numbers are the
one-process run's; scene-parallel evaluation writes the CSV of the serial
loop (each scene's clicks from ``random.Random(seed + i)``) on two CPU
workers.

Tolerances: eval rows within 1e-4 (``tests/test_torch_parallel_rollout.py``
holds the sharded rollouts); the dp run's epoch loss, against nothing but
itself, finite; scene-parallel rows exact."""

import os
import random

import numpy as np
import pytest

from agile3d_torch import eval_multi_obj as pev
from agile3d_torch import main as pmain
from agile3d_torch.config import Config, ModelConfig
from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.eval import (
    InteractiveEngine,
    evaluate_dataset_parallel,
    evaluate_scene,
)
from agile3d_torch.models.agile3d import init_agile3d

SMALL_FLAGS = ["--hidden_dim", "32", "--dim_feedforward", "64",
               "--num_heads", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    return write_benchmark(root, num_scenes=2, num_obj=2, n_points=1500)


def _rows(path):
    with open(path) as f:
        return [r.split(" ") for r in f.read().split("\n") if r]


def _eval(data, out, *extra):
    scans, val_list = data
    args = pev.get_args_parser().parse_args(
        ["--scan_folder", scans, "--val_list", val_list, "--max_num_clicks",
         "2", "--output_dir", str(out)] + SMALL_FLAGS + list(extra))
    return pev.main(args)


def test_eval_sp_self_spawns_and_matches_one_process(data, tmp_path):
    one = _eval(data, tmp_path / "one")
    want = _rows(tmp_path / "one" / "val_results_multi.csv")
    for extra in (["--sp", "2"], ["--sp", "2", "--sp_backbone"]):
        out = tmp_path / "_".join(extra)
        got = _eval(data, out, *extra)
        # rank 0 alone writes; the others wrote to os.devnull
        assert os.listdir(out) == ["val_results_multi.csv"]
        rows = _rows(out / "val_results_multi.csv")
        assert [r[:4] for r in rows] == [r[:4] for r in want]
        np.testing.assert_allclose([float(r[4]) for r in rows],
                                   [float(r[4]) for r in want], atol=1e-4)
        assert got.keys() == one.keys()


def test_sp_backbone_needs_sp(data, tmp_path):
    with pytest.raises(ValueError, match="sp_backbone requires sp > 1"):
        _eval(data, tmp_path, "--sp_backbone")


def test_main_num_dp_self_spawns(data, tmp_path):
    scans, val_list = data
    args = pmain.get_args_parser().parse_args(
        ["--scan_folder", scans, "--train_list", val_list, "--val_list",
         val_list, "--num_dp", "2", "--epochs", "1", "--batch_size", "1",
         "--val_epochs", "1", "--max_num_clicks", "1", "--output_dir",
         str(tmp_path)] + SMALL_FLAGS)
    history = pmain.main(args)
    (stats,) = history["epochs"]
    assert np.isfinite(stats["loss"]) and 0 <= stats["mIoU"] <= 1
    assert set(history["val"]) == {0}
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.pth", "valResults"]
    assert os.listdir(tmp_path / "valResults") == ["val_results_epoch_0.csv"]
    # 2 scenes, one a rank: one step, whose schedule counts dp steps
    assert history["optimizer"].count == 1


def test_scene_parallel_equals_the_serial_loop(data, tmp_path):
    scans, val_list = data
    cfg = Config(model=ModelConfig(hidden_dim=32, dim_feedforward=64,
                                   num_heads=2))
    model = init_agile3d(cfg.model, seed=0, device="cpu")
    ds = InterMultiObjDataset(scans, val_list, 0.05)
    engine = InteractiveEngine(cfg, model, "cpu")
    serial = []
    for i in range(len(ds)):
        serial += evaluate_scene(engine, collate_scenes([ds[i]], cfg.buckets),
                                 instance_id=i, rng=random.Random(5 + i),
                                 max_num_clicks=2)
    for devices in (["cpu"], ["cpu", "cpu"]):
        csv = str(tmp_path / f"par{len(devices)}.csv")
        evaluate_dataset_parallel(cfg, model, ds, csv, devices=devices,
                                  max_num_clicks=2, seed=5,
                                  log=lambda *a: None)
        with open(csv) as f:
            assert f.read() == "\n".join(serial) + "\n"
