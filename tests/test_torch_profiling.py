"""The port's profiling hooks (``agile3d_torch/utils/profiling.py``) on
the CPU: the trace file, nested spans, the no-op form, the memory counters
without a card; then the program's own spans (``agile3d.*``) as a tiny
server, eval and training step leave them under ``torch.profiler``."""

import glob
import json
import os
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from agile3d_torch.utils import profiling


def test_trace_writes_a_trace_with_nested_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("outer_span"):
            with profiling.annotate("inner_span"):
                y = x @ x
    assert prof is not None and y.shape == (64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("name") in ("outer_span", "inner_span")
             and e.get("ph") == "X"}
    assert set(spans) == {"outer_span", "inner_span"}
    outer, inner = spans["outer_span"], spans["inner_span"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer_span", "inner_span"} <= names


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(tmp_path, log_dir):
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("span"):
            torch.ones(3).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_memory_stats_and_the_missing_server():
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats["cuda:0"]) == {"bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit"}
    else:
        assert stats == {}


def test_annotate_without_a_profiler_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span entered the dispatcher")

    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", refuse)
    span = profiling.annotate("agile3d.engine.round")
    assert span is profiling.NO_SPAN
    assert profiling.annotate("agile3d.model.decoder") is span
    with span, profiling.annotate("agile3d.engine.clicks"):
        torch.ones(3).sum()
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("agile3d.engine.round"):
            torch.ones(3).sum()
    # a span is no user annotation: the profiler leaves no copy of it on
    # the device's timeline, where it would read as device work
    (ev,) = [e for e in prof.events() if e.name == "agile3d.engine.round"]
    assert not ev.is_user_annotation


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------


def _config(prefetch: int = 2):
    import dataclasses

    from agile3d_torch.config import (
        BackboneConfig,
        Config,
        ModelConfig,
        TrainConfig,
    )

    model = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                        max_clicks=64,
                        backbone=BackboneConfig(
                            init_dim=8, planes=(8, 8, 16, 16, 16, 16, 8, 8),
                            layers=(1,) * 8))
    return dataclasses.replace(
        Config(model=model, buckets=(1024, 2048, 4096)),
        train=TrainConfig(batch_size=2, prefetch=prefetch))


def _spans(prof):
    """The program's spans, (name, start, end, thread), in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events()
                   if e.name.startswith("agile3d.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer, name):
    """The spans called ``name`` nested in ``outer`` on its thread."""
    return [s for s in spans if s[0] == name and s[3] == outer[3]
            and outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    from agile3d_torch.data.synthetic import write_benchmark

    return write_benchmark(str(tmp_path_factory.mktemp("spans")),
                           num_scenes=2, num_obj=2, seed=0, n_points=1200)


def test_server_click_spans(tmp_path):
    from agile3d_torch.data.ply import write_ply
    from agile3d_torch.data.synthetic import make_scene
    from agile3d_torch.interactive import (
        InteractiveDataLoader,
        InteractiveSegmentationServer,
    )

    coords, colors, labels = make_scene(np.random.default_rng(0),
                                        n_points=1200, num_obj=2)
    d = tmp_path / "scene_a"
    d.mkdir()
    xyz = {"x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2]}
    write_ply(str(d / "scan.ply"), {**xyz, "R": colors[:, 0],
                                    "G": colors[:, 1], "B": colors[:, 2]})
    write_ply(str(d / "label.ply"), {**xyz, "label": labels})
    server = InteractiveSegmentationServer(
        InteractiveDataLoader(str(tmp_path), "user"), cfg=_config(),
        device="cpu")
    idx, times = {}, {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.load_scene(0)
        for t, o in enumerate((1, 2, 1)):
            p = int(np.nonzero(labels == o)[0][t])
            idx.setdefault(str(o), []).append(server.nearest_voxel(coords[p]))
            times.setdefault(str(o), []).append(t)
            server.get_next_click(idx, times)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("agile3d.server.load_scene") == 1
    load = next(s for s in spans if s[0] == "agile3d.server.load_scene")
    assert len(_inside(spans, load, "agile3d.data.prepare")) == 1
    assert len(_inside(spans, load, "agile3d.model.backbone")) == 1
    assert names.count("agile3d.server.nearest_voxel") == 3
    clicks = [s for s in spans if s[0] == "agile3d.server.click"]
    assert len(clicks) == 3
    for c in clicks:
        for inner in ("agile3d.engine.wait", "agile3d.model.decoder",
                      "agile3d.server.record"):
            assert len(_inside(spans, c, inner)) == 1, inner
    assert names.count("agile3d.engine.wait") == 3


def test_device_eval_round_spans(scans, tmp_path):
    from agile3d_torch.data.datasets import build_dataset
    from agile3d_torch.engine.eval import InteractiveEngine, evaluate_dataset
    from agile3d_torch.models.agile3d import init_agile3d

    cfg = _config()
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=1,
                                                 device="cpu"), "cpu")
    dataset = build_dataset("val", "multi_obj", scan_folder=scans[0],
                            scene_list=scans[1], voxel_size=0.05)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        evaluate_dataset(engine, dataset, str(tmp_path / "val.csv"),
                         max_num_clicks=3, seed=5, log=lambda m: None)
    with open(tmp_path / "val.csv") as f:
        assert len(f.read().splitlines()) == 6 * len(dataset)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    scenes = [s for s in spans if s[0] == "agile3d.engine.scene"]
    assert len(scenes) == len(dataset) == names.count("agile3d.data.wait")
    for sc in scenes:
        assert len(_inside(spans, sc, "agile3d.engine.round0")) == 1
        assert len(_inside(spans, sc, "agile3d.engine.wait")) == 1
        (rollout,) = _inside(spans, sc, "agile3d.engine.rollout")
        rounds = _inside(spans, rollout, "agile3d.engine.round")
        # 2 objects x 3 clicks: round 0 on the host clicks both, then
        # 6 - 2 + 1 device rounds, one a click bucket entry
        assert len(rounds) == 5
        for r in rounds:
            assert len(_inside(spans, r, "agile3d.model.decoder")) == 1
            assert len(_inside(spans, r, "agile3d.engine.clicks")) == 1


def test_training_step_spans(scans):
    from agile3d_torch.data.datasets import build_dataset
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.engine.train import (
        make_optimizer,
        make_train_step,
        train_one_epoch,
    )
    from agile3d_torch.models.agile3d import init_agile3d

    cfg = _config()
    dataset = build_dataset("train", "multi_obj", scan_folder=scans[0],
                            scene_list=scans[1], voxel_size=0.05, seed=3)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=1,
                                                 device="cpu"), "cpu")
    opt, _ = make_optimizer(engine.model, cfg, 1)
    step = make_train_step(cfg, engine.model, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_one_epoch(engine, step, dataset, cfg, 0,
                        np_rng=np.random.default_rng(7),
                        py_rng=random.Random(7), log=lambda m: None,
                        device_rollout=True)
    names = [s[0] for s in _spans(prof)]
    # one batch of 2 scenes: one step
    assert names.count("agile3d.engine.rollout") == 1
    assert names.count("agile3d.engine.step") == 1
    assert names.count("agile3d.data.wait") == 1
    assert names.count("agile3d.engine.round") >= 1
