"""The port's batch prefetcher against the JAX package's: results in
submission order, a worker's exception at its item, depth 0 as a plain map;
then the training epoch and the eval CSV unchanged by the depth."""

import random
import threading
import time

import numpy as np
import pytest
import torch

from agile3d_torch.data.prefetch import BatchPrefetcher
from agile3d_tpu.data.prefetch import BatchPrefetcher as JaxPrefetcher

torch.set_num_threads(1)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_order_equals_jax(depth):
    fn = lambda x: (x * 7) % 5
    want = list(JaxPrefetcher(fn, range(20), depth=depth))
    assert list(BatchPrefetcher(fn, range(20), depth=depth)) == want
    assert want == [fn(x) for x in range(20)]


@pytest.mark.parametrize("depth", [0, 2])
def test_worker_error_at_its_item_as_jax(depth):
    def fn(x):
        if x == 3:
            raise ValueError("boom")
        return x

    for cls in (BatchPrefetcher, JaxPrefetcher):
        got = []
        with pytest.raises(ValueError, match="boom"):
            for r in cls(fn, range(6), depth=depth):
                got.append(r)
        assert got == [0, 1, 2]


def test_depth_zero_is_synchronous():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    it = iter(BatchPrefetcher(fn, range(5), depth=0))
    assert calls == []
    assert next(it) == 0 and calls == [0]
    assert list(it) == [1, 2, 3, 4]


def test_depth_bounds_what_runs_ahead():
    ahead, consumed = 0, 0
    lock = threading.Lock()

    def fn(x):
        nonlocal ahead
        with lock:
            ahead = max(ahead, x - consumed)
        return x

    for r in BatchPrefetcher(fn, range(12), depth=2):
        time.sleep(0.01)
        with lock:
            consumed = r + 1
    assert ahead <= 2


def test_close_stops_the_workers():
    pf = BatchPrefetcher(lambda x: x, range(100), depth=1)
    it = iter(pf)
    next(it)
    pf.close()
    pf.close()


# ---------------------------------------------------------------------------
# the loops that use it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    from agile3d_torch.data.synthetic import write_benchmark

    return write_benchmark(str(tmp_path_factory.mktemp("prefetch")),
                           num_scenes=4, num_obj=2, seed=0, n_points=1200)


def _small_config(prefetch: int):
    import dataclasses

    from agile3d_torch.config import BackboneConfig, Config, ModelConfig
    from agile3d_torch.config import TrainConfig

    model = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                        max_clicks=64,
                        backbone=BackboneConfig(
                            init_dim=8, planes=(8, 8, 16, 16, 16, 16, 8, 8),
                            layers=(1,) * 8))
    return dataclasses.replace(
        Config(model=model, buckets=(1024, 2048, 4096)),
        train=TrainConfig(batch_size=2, prefetch=prefetch))


def _train(scans, prefetch: int):
    from agile3d_torch.data.datasets import build_dataset
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.engine.train import (
        make_optimizer,
        make_train_step,
        train_one_epoch,
    )
    from agile3d_torch.models.agile3d import init_agile3d

    cfg = _small_config(prefetch)
    dataset = build_dataset("train", "multi_obj", scan_folder=scans[0],
                            scene_list=scans[1], voxel_size=0.05, seed=3)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=1,
                                                 device="cpu"), "cpu")
    opt, _ = make_optimizer(engine.model, cfg, 2)
    step = make_train_step(cfg, engine.model, opt)
    stats = train_one_epoch(engine, step, dataset, cfg, 0,
                            np_rng=np.random.default_rng(7),
                            py_rng=random.Random(7), log=lambda m: None)
    return stats, engine.model.state_dict()


def test_training_epoch_is_the_same_at_every_depth(scans):
    stats0, sd0 = _train(scans, 0)
    stats2, sd2 = _train(scans, 2)
    assert stats0 == stats2
    assert all(torch.equal(sd0[k], sd2[k]) for k in sd0)


def test_eval_csv_is_the_same_with_and_without_prefetch(scans, tmp_path,
                                                        monkeypatch):
    from agile3d_torch.data.datasets import build_dataset
    from agile3d_torch.engine import eval as peval
    from agile3d_torch.engine.eval import InteractiveEngine, evaluate_dataset
    from agile3d_torch.models.agile3d import init_agile3d

    cfg = _small_config(2)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=1,
                                                 device="cpu"), "cpu")
    dataset = build_dataset("val", "multi_obj", scan_folder=scans[0],
                            scene_list=scans[1], voxel_size=0.05)
    csvs = []
    seen = []
    for depth in (0, 2):
        def prefetcher(fn, items, depth, forced=depth):
            seen.append(depth)
            return BatchPrefetcher(fn, items, depth=forced)

        monkeypatch.setattr(peval, "BatchPrefetcher", prefetcher)
        path = str(tmp_path / f"depth{depth}.csv")
        evaluate_dataset(engine, dataset, path, max_num_clicks=2, seed=5,
                         log=lambda m: None, device_rollout=False)
        csvs.append(open(path).read())
    assert seen == [2, 2]  # the depth evaluate_dataset asks for
    assert csvs[0] == csvs[1] and len(csvs[0].splitlines()) > 4
