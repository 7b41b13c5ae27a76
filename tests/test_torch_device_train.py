"""The port's device training rollout (``agile3d_torch/engine/
device_train.py``) against the JAX package's ``engine/device_train.py`` and
against the port's host rollout (``engine/train.py::rollout_clicks``), on
the CPU at the reduced width of ``tests/test_torch_model.py``.

With the host rollout's shuffle pinned to the identity, the two port paths
must give the same click SETS per sample (voxels, objects and count); the
click times may differ by the order within a round, the one place the
device path draws its own random numbers (as ``tests/test_device_train.py``
holds the JAX paths). The per-round selection equals the JAX function's
exactly for the same uniform draws."""

import dataclasses
import math
import random as pyrandom

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch import main as pmain
from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine import train as ptrain
from agile3d_torch.engine.device_train import (
    multi_cluster_clicks_device,
    train_rollout,
)
from agile3d_torch.engine.eval import InteractiveEngine
from agile3d_torch.engine.train import (
    device_click_state,
    rollout_clicks,
    subsample_objects,
)
from agile3d_torch.models.agile3d import ClickState, init_agile3d
from agile3d_tpu.engine import device_train as jdt
from tests.test_torch_model import SMALL
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)


class PinnedRng(pyrandom.Random):
    """Host rollout RNG with the identity shuffle and a fixed round count."""

    def __init__(self, num_iters):
        super().__init__(0)
        self._n = num_iters

    def randint(self, a, b):
        return self._n

    def shuffle(self, x):
        pass


def _selection_inputs(seed, n=1024):
    rng = np.random.default_rng(seed)
    coords = (rng.random((n, 3)) * 4).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    pred = labels.copy()
    flip = rng.random(n) < 0.3
    pred[flip] = rng.integers(0, 5, flip.sum())
    valid = rng.random(n) < 0.95
    return pred, labels, coords, valid


@pytest.mark.parametrize("seed,num_obj", [(0, 3), (1, 1), (2, 10), (3, 0)])
def test_multi_cluster_clicks_match_jax(seed, num_obj):
    pred, labels, coords, valid = _selection_inputs(seed)
    key = jax.random.PRNGKey(seed)
    want = jdt.multi_cluster_clicks_device(
        jnp.asarray(pred), jnp.asarray(labels), jnp.asarray(coords),
        jnp.asarray(valid), jnp.asarray(num_obj), key)
    # the same uniform draws that the JAX function ranks
    u = np.asarray(jax.random.uniform(key, (10,)))
    got = multi_cluster_clicks_device(
        *(torch.from_numpy(a)[None] for a in (pred, labels, coords, valid)),
        torch.tensor([num_obj]), torch.from_numpy(u.copy())[None])
    vox, obj, rank, sel = (np.asarray(t[0]) for t in got)
    w_vox, w_obj, w_rank, w_sel = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(sel, w_sel)
    np.testing.assert_array_equal(vox[sel], w_vox[w_sel])
    np.testing.assert_array_equal(obj[sel], w_obj[w_sel])
    np.testing.assert_array_equal(rank, w_rank)
    live = int(sel.sum())
    assert live == min(num_obj, 10, live) and (num_obj == 0) == (live == 0)
    assert sorted(rank[sel].tolist()) == list(range(live))
    assert (labels[vox[sel]] == obj[sel]).all()
    assert (pred[vox[sel]] != labels[vox[sel]]).all()


def _small():
    return Config(model=dataclasses.replace(port_model_config(SMALL),
                                            max_clicks=64),
                  buckets=(512, 1024, 4096))


@pytest.fixture(scope="module")
def batch_and_model(tmp_path_factory):
    """Two synthetic scenes in one batch and a SMALL model on the CPU."""
    cfg = _small()
    scans, lst = write_benchmark(str(tmp_path_factory.mktemp("train")),
                                 num_scenes=2, num_obj=3, seed=0,
                                 n_points=1200)
    ds = InterMultiObjDataset(scans, lst, cfg.model.voxel_size)
    batch = collate_scenes([ds[0], ds[1]], cfg.buckets)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=0,
                                                 device="cpu"), "cpu")
    scene = engine.run_backbone(batch, training=True)
    return cfg, batch, engine, scene


@pytest.mark.parametrize("num_iters,num_obj_cap", [(0, 3), (3, 1), (4, 3),
                                                   (2, 10)])
def test_device_rollout_click_sets_match_host(batch_and_model, num_iters,
                                              num_obj_cap):
    """The device rollout's clicks in the host's pinned order: increasing
    draws rank each round's clicks by the clusters' ranking, as the
    identity shuffle leaves them (the click order feeds the decoder through
    the time encoding, so the later rounds depend on it)."""
    cfg, batch, engine, scene = batch_and_model
    b = batch.labels.shape[0]
    n_valid = [int((batch.sample_idx[i] >= 0).sum()) for i in range(b)]
    labels = batch.labels.copy()
    num_obj = np.zeros(b, np.int32)
    rng = np.random.default_rng(1)
    for i in range(b):
        labels[i], num_obj[i] = subsample_objects(batch.labels[i], rng,
                                                  num_obj_cap)
    raw, off = [], 0
    for i in range(b):
        raw.append(batch.raw[off: off + n_valid[i]])
        off += n_valid[i]
    host = rollout_clicks(engine, scene, labels, num_obj, raw, n_valid,
                          PinnedRng(num_iters), cfg)
    mc = engine._click_bucket((num_iters + 1) * cfg.model.max_fg_objects)
    s_cap = cfg.model.max_fg_objects
    pinned = torch.arange(s_cap, dtype=torch.float32).expand(b, s_cap)
    cs, counts = train_rollout(engine.model, scene, torch.from_numpy(labels),
                               torch.from_numpy(num_obj), num_iters,
                               torch.Generator().manual_seed(7), mc,
                               s_cap, order=pinned)
    vox, obj, tim = (t.numpy() for t in cs)
    counts = counts.numpy()
    assert cs.vox.shape == (b, mc)
    for i in range(b):
        hc = host[i]
        assert counts[i] == hc.count > 0, i
        host_set = sorted(zip(hc.vox[:hc.count].tolist(),
                              hc.obj[:hc.count].tolist()))
        dev_set = sorted(zip(vox[i, :counts[i]].tolist(),
                             obj[i, :counts[i]].tolist()))
        assert host_set == dev_set, i
        assert sorted(tim[i, :counts[i]].tolist()) == list(range(counts[i]))
        assert (labels[i][vox[i, :counts[i]]] == obj[i, :counts[i]]).all()
        assert (vox[i, counts[i]:] == -1).all()
        # the same order as well
        np.testing.assert_array_equal(
            hc.vox[:hc.count][np.argsort(hc.time[:hc.count])],
            vox[i, :counts[i]][np.argsort(tim[i, :counts[i]])])


def test_device_rollout_without_errors_adds_nothing(batch_and_model):
    cfg, batch, engine, scene = batch_and_model
    labels = torch.from_numpy(np.where(batch.labels >= 0, 0, -1)
                              .astype(np.int32))
    cs, counts = train_rollout(engine.model, scene, labels,
                               torch.zeros(2, dtype=torch.int32), 0,
                               torch.Generator().manual_seed(0), 32)
    assert (counts == 0).all() and (cs.vox == -1).all()


def test_device_click_state_cuts_or_pads_to_the_step_bucket():
    vox = torch.arange(2 * 32, dtype=torch.int32).reshape(2, 32)
    cs = ClickState(vox, vox + 1, vox + 2)
    got = device_click_state(cs, torch.tensor([3, 30]), 256)
    assert got.vox.shape == (2, 64)
    assert torch.equal(got.vox[:, :32], vox) and (got.vox[:, 32:] == -1).all()
    assert (got.obj[:, 32:] == 0).all() and (got.time[:, 32:] == 0).all()
    big = ClickState(*(torch.zeros(2, 256, dtype=torch.int32)
                       for _ in range(3)))
    assert device_click_state(big, torch.tensor([3, 65]), 256).vox.shape == \
        (2, 256)
    assert device_click_state(big, torch.tensor([3, 64]), 256).vox.shape == \
        (2, 64)


def test_training_entry_point_with_device_rollout(tmp_path, monkeypatch):
    """``python -m agile3d_torch.main --device_rollout`` on the CPU: one
    epoch of two steps through the device rollout, each drawing its round
    count from the python stream and its generator seed from numpy's."""
    small = port_model_config(SMALL)
    build = pmain.build_config
    monkeypatch.setattr(pmain, "build_config",
                        lambda args: dataclasses.replace(build(args),
                                                         model=small))
    seen = []
    real = ptrain.train_rollout
    monkeypatch.setattr(ptrain, "train_rollout",
                        lambda *a, **k: seen.append(a[4]) or real(*a, **k))
    monkeypatch.setattr(ptrain, "rollout_clicks", None)  # never called
    scans, lst = write_benchmark(str(tmp_path / "data"), num_scenes=3,
                                 num_obj=3, seed=2, n_points=1500)
    args = pmain.get_args_parser().parse_args([
        "--scan_folder", scans, "--train_list", lst, "--val_list", lst,
        "--epochs", "1", "--val_epochs", "2", "--batch_size", "2",
        "--max_num_clicks", "1", "--output_dir", str(tmp_path / "out"),
        "--seed", "0", "--device", "cpu", "--device_rollout"])
    hist = pmain.main(args, log=lambda m: None)
    (stats,) = hist["epochs"]
    assert all(math.isfinite(v) for v in stats.values())
    py_rng = pyrandom.Random(0)
    assert seen == [py_rng.randint(0, 19), py_rng.randint(0, 19)]
