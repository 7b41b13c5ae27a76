"""The port's benches on the CPU at a tiny scene and a reduced model: each
prints one JSON line with the JAX benches' keys, and its roofline counts
are ``utils/costs.py``'s for the same batch (which equal the JAX package's,
``tests/test_torch_costs.py``)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from agile3d_torch import bench, bench_train
from agile3d_torch.config import BackboneConfig, Config, ModelConfig
from agile3d_torch.data.datasets import collate_scenes
from agile3d_torch.utils.costs import backbone_costs, decoder_costs, summarize

torch.set_num_threads(1)

SMALL = Config(model=ModelConfig(
    hidden_dim=32, dim_feedforward=64, num_heads=4,
    backbone=BackboneConfig(init_dim=8, planes=(8, 8, 16, 16, 16, 16, 8, 8),
                            layers=(1,) * 8)))


@pytest.fixture(autouse=True)
def small_model(monkeypatch):
    """The benches at a reduced width: their Config() is SMALL's."""
    make = lambda **kw: dataclasses.replace(SMALL, **kw)
    monkeypatch.setattr(bench, "Config", make)
    monkeypatch.setattr(bench_train, "Config", make)


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_bench_prints_its_json_line(capsys):
    args = bench.get_args_parser().parse_args(
        ["--device", "cpu", "--n_points", "3000", "--reps", "2", "--warmup",
         "1", "--backbone_reps", "1"])
    bench.main(args)
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "raw",
                         "roofline"}
    assert line["metric"] == "per_click_forward_mask_p50_latency"
    assert line["unit"] == "ms" and line["value"] > 0
    np.testing.assert_allclose(line["vs_baseline"], 50.0 / line["value"])
    assert line["raw"]["device"].startswith("cpu")
    assert set(line["roofline"]) == {"backbone", "forward_mask",
                                     "forward_mask_bf16", "backbone_stages"}
    assert line["raw"]["backbone"]["calls"] == 3  # warm-up, rep, the scene

    # the same scene and batch, counted again
    rng = np.random.default_rng(0)
    sample = bench.quantized_sample(*bench.noisy_scene(rng, 3000, 8, 8.0), 8,
                                    SMALL.model.voxel_size)
    batch = collate_scenes([sample], SMALL.buckets)
    bb = summarize(backbone_costs(batch.pyramid, SMALL.model.backbone))
    rows = batch.pyramid.levels[0].grid.shape[0]
    q = SMALL.model.num_bg_queries + 32
    fm = summarize(decoder_costs(rows, q, SMALL.model))
    fm16 = summarize(decoder_costs(rows, q, SMALL.model, dtype_bytes=2))
    assert (line["raw"]["rows"], line["raw"]["queries"]) == (rows, q)
    for key in ("model_flops", "stream_bytes", "gather_rows"):
        assert line["roofline"]["backbone"][key] == bb[key]
        assert line["roofline"]["forward_mask"][key] == fm[key]
        assert line["roofline"]["forward_mask_bf16"][key] == fm16[key]
    assert line["roofline"]["backbone"]["padded_flops"] == summarize(
        backbone_costs(batch.pyramid, SMALL.model.backbone,
                       padded=True))["model_flops"]
    assert "mfu" in line["roofline"]["forward_mask"]


def test_bench_train_prints_its_json_line(capsys):
    args = bench_train.get_args_parser().parse_args(
        ["--device", "cpu", "--batch_size", "2", "--n_points", "1500",
         "--reps", "1", "--batches", "1"])
    bench_train.main(args)
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "breakdown", "roofline"}
    assert line["metric"] == "train_scenes_per_sec_per_chip"
    bd = line["breakdown"]
    for key in ("supervised_step_ms", "host_batch_assembly_ms",
                "epoch_step_serial_ms", "epoch_step_prefetch_ms",
                "batch_scenes", "batch_voxels", "padded_rows"):
        assert key in bd
    # warm-up, 1 timed, 1 warming the loop, then serial and prefetched
    # epochs of 1 batch on the native host path and again on numpy's
    assert bd["batch_scenes"] == 2 and bd["steps"] == 7
    assert bd["host_path"] == "native"
    assert set(bd["numpy_host"]) == {"host_batch_assembly_ms",
                                     "epoch_step_serial_ms",
                                     "epoch_step_prefetch_ms"}
    assert all(v > 0 for v in bd["numpy_host"].values())
    np.testing.assert_allclose(line["value"],
                               2 / (bd["supervised_step_ms"] / 1e3))

    rng = np.random.default_rng(0)
    samples = [bench.quantized_sample(*bench.noisy_scene(rng, 1500, 6, 6.0),
                                      6, SMALL.model.voxel_size)
               for _ in range(2)]
    batch = collate_scenes(samples, SMALL.buckets)
    rows = batch.pyramid.levels[0].grid.shape[0]
    assert bd["padded_rows"] == rows
    assert bd["batch_voxels"] == sum(len(s.vox_coords) for s in samples)
    fwd = (summarize(backbone_costs(batch.pyramid, SMALL.model.backbone))
           ["model_flops"]
           + summarize(decoder_costs(rows, SMALL.model.num_bg_queries + 64,
                                     SMALL.model))["model_flops"])
    assert line["roofline"]["step_flops_3x_fwd"] == 3 * fwd
    assert set(line["roofline"]) == {"step_flops_3x_fwd", "achieved_tflops",
                                     "mfu"}


def test_defaults_are_the_jax_benches_sizes(monkeypatch):
    """bench.py's ScanNet-scale scene (400,000 points) and bench_train.py's
    batch (5 scenes of 150,000 points), at least 20 timed passes."""
    a = bench.get_args_parser().parse_args([])
    assert (a.device, a.n_points, a.backbone_reps) == ("cuda", 400000, 5)
    assert a.reps >= 20
    t = bench_train.get_args_parser().parse_args([])
    assert (t.device, t.batch_size, t.n_points) == ("cuda", 5, 150000)
