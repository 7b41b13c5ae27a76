"""The port's dp epoch table (``agile3d_torch/tools/bench_dp_scaling.py``)
against the repository's JAX tool (``tools/bench_dp_scaling.py``) on the
CPU.

The tool's configuration and its 64 scenes equal those that the JAX tool's
code builds. One width-2 epoch of 2 steps on two spawned ``gloo`` ranks,
from JAX's seeded weights carried across by the bridge
(``utils/ckpt.py::export_torch_state_dict``), gives the epoch averages of
JAX's ``dp_train_one_epoch`` on a 2-device CPU mesh at the tolerances that
``tests/test_torch_parallel_train.py::test_pair_matches_jax_dp_step`` holds
the dp step to (loss and grad norm within rtol 1e-4, mIoU within 1e-6; the
two loss terms at the loss's 1e-4). Two draws come from generators of each
package's own, so both sides pin them alike: the object subsets
(``torch_parallel_ranks.first_objects``) and the order of each round's
clicks (the uniform draws that rank them all equal: the clusters' order).
Then the tool's table on the CPU."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from agile3d_torch.parallel.mesh import spawn
from agile3d_torch.tools import bench_dp_scaling
from tests import torch_parallel_ranks as ranks
from tests.test_torch_weights import port_model_config

torch.set_num_threads(2)
STEPS, WIDTH = 2, 2


def _jax_tool_config():
    """The JAX tool's configuration, built as its ``main`` builds it."""
    from agile3d_tpu.config import BackboneConfig, Config, ModelConfig, TrainConfig

    small_bb = BackboneConfig(init_dim=8, planes=(8,) * 8, layers=(1,) * 8)
    return Config(model=ModelConfig(max_clicks=32, hidden_dim=32,
                                    dim_feedforward=64, num_heads=2,
                                    backbone=small_bb),
                  train=TrainConfig(batch_size=1, prefetch=2),
                  buckets=(512, 1024, 2048))


def _jax_tool_scenes(cfg):
    """The JAX tool's 64 scenes, built as its ``main`` builds them."""
    from agile3d_tpu.data.datasets import SceneSample
    from agile3d_tpu.data.synthetic import make_scene
    from agile3d_tpu.sparse.quantize import sparse_quantize

    rng = np.random.default_rng(0)
    scenes = []
    for i in range(64):
        coords, colors, labels = make_scene(rng, n_points=900, num_obj=2)
        vox, umap, imap = sparse_quantize(coords, cfg.model.voxel_size)
        scenes.append(SceneSample(
            vox_coords=vox, raw_coords=coords[umap],
            feats=colors[umap].astype(np.float32) / 255.0,
            labels=labels[umap].astype(np.int32),
            labels_full=labels.astype(np.int32), inverse_map=imap,
            click_idx={}, scene_name=f"s{i}", num_obj=2))
    return scenes


def test_config_matches_jax():
    jcfg = _jax_tool_config()
    cfg = bench_dp_scaling.dp_config()
    assert cfg.model == port_model_config(jcfg.model)
    assert tuple(cfg.buckets) == tuple(jcfg.buckets)
    shared = [f.name for f in dataclasses.fields(cfg.train)
              if hasattr(jcfg.train, f.name)]
    assert shared and all(getattr(cfg.train, n) == getattr(jcfg.train, n)
                          for n in shared)
    assert (cfg.train.batch_size, cfg.train.prefetch) == (1, 2)
    assert bench_dp_scaling.FixedRng(0).randint(0, 19) == 2


def test_scenes_match_jax():
    want = _jax_tool_scenes(_jax_tool_config())
    got = bench_dp_scaling.dp_scenes(bench_dp_scaling.dp_config())
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name in g._fields:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


def _jax_epoch(jcfg, scenes, params, buffers, bn_state, monkeypatch):
    """JAX's ``dp_train_one_epoch`` as the JAX tool calls it, on a 2-device
    mesh, with the object subsets and the click order pinned."""
    import jax
    import jax.numpy as jnp

    import agile3d_tpu.engine.train as jtrain
    from agile3d_tpu.engine.train import make_optimizer
    from agile3d_tpu.parallel import make_mesh
    from agile3d_tpu.parallel.train import dp_train_one_epoch, make_dp_train_step

    monkeypatch.setattr(jtrain, "subsample_objects", ranks.first_objects)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.zeros(shape, dtype))
    mesh = make_mesh(n_dp=WIDTH, n_sp=1)
    tx, _ = make_optimizer(jcfg, steps_per_epoch=4)
    step, shard_fn, _ = make_dp_train_step(jcfg, tx, mesh)
    *_, stats = dp_train_one_epoch(
        jcfg, mesh, params, buffers, bn_state, tx.init(params), step,
        shard_fn, scenes, epoch=0, np_rng=np.random.default_rng(1),
        py_rng=bench_dp_scaling.FixedRng(0), log=lambda *a: None,
        order=np.arange(len(scenes)))
    return stats


def test_epoch_matches_jax_dp_train_one_epoch(monkeypatch):
    import jax

    from agile3d_tpu.data.datasets import SceneSample as JaxSample
    from agile3d_tpu.models.agile3d import init_agile3d
    from agile3d_tpu.utils.ckpt import export_torch_state_dict

    jcfg = _jax_tool_config()
    cfg = bench_dp_scaling.dp_config()
    scenes = bench_dp_scaling.dp_scenes(cfg, STEPS * WIDTH)
    params, buffers, bn_state = init_agile3d(jax.random.PRNGKey(0),
                                             jcfg.model)
    sd = export_torch_state_dict(params, buffers, jcfg.model, bn_state)
    got = spawn(ranks.pinned_dp_epoch, WIDTH, cfg, scenes, sd, device="cpu")
    want = _jax_epoch(jcfg, [JaxSample(**s._asdict()) for s in scenes],
                      params, buffers, bn_state, monkeypatch)
    for rank in got:
        stats = rank[0]["stats"]
        assert set(stats) == set(want) == {"loss", "grad_norm", "mIoU",
                                           "loss_bce", "loss_dice"}
        for key in ("loss", "grad_norm", "loss_bce", "loss_dice"):
            np.testing.assert_allclose(stats[key], want[key], rtol=1e-4,
                                       err_msg=key)
        np.testing.assert_allclose(stats["mIoU"], want["mIoU"], atol=1e-6)
    # the averages are the group's, the same on both ranks
    assert got[0][0]["stats"] == got[1][0]["stats"]


def test_table_on_the_cpu():
    lines = []
    res = bench_dp_scaling.run(widths=(WIDTH,), steps=1, device="cpu",
                               log=lines.append)
    assert lines[0] == ("dp | scenes/step | steps | epoch wall s | ms/step "
                        "| scenes/s")
    assert lines[1].split("|")[:3] == [" 2 ", "           2 ", "     1 "]
    assert lines[-1].startswith("{") and len(lines) == 3
    (row,) = res["rows"]
    assert (row["dp"], row["scenes_per_step"], row["steps"]) == (2, 2, 1)
    assert row["backend"] == "gloo" and row["warm_wall_s"] > 0
    assert row["scenes_per_s"] == pytest.approx(2 / row["epoch_wall_s"])
    assert all(math.isfinite(v) for v in row["stats"].values())
    # plain versions on the CPU: no kernel launch in either epoch
    assert all(set(e.values()) == {0} for e in row["launches"])
    assert res["rollout_rounds"] == 3 and res["device"].startswith("cpu")


def test_refuses_more_steps_than_scenes_and_needs_a_card():
    with pytest.raises(SystemExit):
        bench_dp_scaling.run(widths=(8,), steps=9, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_dp_scaling.main([])
