"""The port's voxel-sharded backbone (``agile3d_torch/parallel/
sp_backbone.py``) against the JAX package's on the CPU.

``partition_pyramid`` is host numpy in both packages and must agree bit
for bit (every remapped map, ``halo_src``, the halo ladder, the refusal of
a level that the rank count does not divide), on the JAX SP-backbone
tests' scene (6,000 points, ``tests/test_sp_backbone.py::_scene_batch``) at
2 and 4 ranks. The halo-exchange UNet on a spawned 2-rank ``gloo`` group
is held against JAX's one-process ``forward_backbone`` (the JAX SP tests
show JAX's sharded backbone equal to it, and are ``slow`` for their
8-device compile) at ``tests/test_sp_backbone.py::_small_cfg`` with random
BatchNorm statistics, at that test's tolerances: ``mask_feat`` within
2e-4, ``pos_pcd`` within 1e-5, cmin / cmax within 1e-6. Its cross-rank
training moments are held against the port's one-process training
BatchNorm (itself held against JAX in ``tests/test_torch_train.py``) at
the JAX test's 2e-4 / 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.data.datasets import SceneSample as PortSample
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.parallel import sp_backbone as psb
from agile3d_torch.parallel.mesh import spawn
from agile3d_torch.sparse.grid import to_device
from agile3d_tpu.models.agile3d import forward_backbone
from agile3d_tpu.parallel import sp_backbone as jsb
from tests import torch_parallel_ranks as ranks
from tests.test_sp_backbone import BUCKETS, _scene_batch, _small_cfg
from tests.test_torch_model import randomized_weights
from tests.test_torch_weights import port_model_config


@pytest.fixture(scope="module")
def scene():
    cfg = _small_cfg()
    jbatch, sample = _scene_batch(cfg)
    pbatch = port_collate([PortSample(**sample._asdict())], BUCKETS)
    return cfg, jbatch, pbatch


@pytest.mark.parametrize("n_sp", [2, 4])
def test_partition_pyramid_equals_jax(scene, n_sp):
    _, jbatch, pbatch = scene
    want = jsb.partition_pyramid(jbatch.pyramid, n_sp)
    got = psb.partition_pyramid(pbatch.pyramid, n_sp)
    assert len(got.levels) == len(want.levels) == 5
    halos = []
    for g, w in zip(got.levels, want.levels):
        assert g._fields == w._fields
        for name in g._fields:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
        halos.append(int((g.halo_src >= 0).sum()))
    # some rows do cross the ranks' edges, and every halo slot has one owner
    assert sum(halos) > 0
    for g in got.levels:
        h = g.halo_src.reshape(n_sp, -1)
        assert ((h >= 0).sum(0) <= 1).all()


def test_halo_ladder_and_refusal_equal_jax(scene):
    for n in list(range(0, 3000, 7)) + [10 ** 5, 123457]:
        assert psb._halo_bucket(n) == jsb._halo_bucket(n), n
    # the rungs round 1.5x up to the 128 grain (JAX's docstring lists
    # 192, 288, 448, which its code does not give)
    assert [psb._halo_bucket(n) for n in (1, 129, 257, 385, 641)] == [
        128, 256, 384, 640, 1024]
    _, jbatch, pbatch = scene
    with pytest.raises(ValueError) as jerr:
        jsb.partition_pyramid(jbatch.pyramid, 3)
    with pytest.raises(ValueError) as perr:
        psb.partition_pyramid(pbatch.pyramid, 3)
    assert str(perr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def runs(scene):
    jcfg, jbatch, pbatch = scene
    sd, params, buffers, bn_state = randomized_weights(
        jcfg.model, 0, np.random.default_rng(4))
    want, _ = jax.jit(lambda p, bf, bs, f, r, si: forward_backbone(
        p, bf, bs, jbatch.pyramid, f, r, si, training=False,
        cfg=jcfg.model))(params, buffers, bn_state, jnp.asarray(jbatch.feats),
                         jnp.asarray(jbatch.raw),
                         jnp.asarray(jbatch.sample_idx))
    pcfg = port_model_config(jcfg.model)
    got = spawn(ranks.sp_backbone_cases, 2,
                [(pcfg, sd, pbatch, False), (pcfg, sd, pbatch, True)],
                device="cpu")
    return dict(want=want, got=got, sd=sd, pcfg=pcfg, pbatch=pbatch)


def _joined(got, i, key):
    return np.concatenate([g[i][key] for g in got], axis=1)


def test_sp_backbone_matches_jax(runs):
    want, got = runs["want"], runs["got"]
    for g in got:   # the whole scene's box on every rank
        np.testing.assert_allclose(g[0]["cmin"], np.asarray(want.cmin),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(g[0]["cmax"], np.asarray(want.cmax),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_joined(got, 0, "vox_valid"),
                                  np.asarray(want.vox_valid))
    np.testing.assert_allclose(_joined(got, 0, "mask_feat"),
                               np.asarray(want.mask_feat), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(_joined(got, 0, "pos_pcd"),
                               np.asarray(want.pos_pcd), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(_joined(got, 0, "raw"),
                                  np.asarray(want.raw))


def test_sp_backbone_training_moments(runs):
    """Training-mode BatchNorm over both ranks' rows: the new running
    statistics of every layer equal the one-process training forward's,
    and are the same on both ranks."""
    pbatch = runs["pbatch"]
    model = ranks.model_from(runs["pcfg"], runs["sd"])
    stats = {}
    with torch.no_grad():
        model.backbone(to_device(pbatch.pyramid, "cpu"),
                       torch.from_numpy(pbatch.feats), stats)
    names = {id(m.bn): n for n, m in model.named_modules() if hasattr(m, "bn")}
    want = {names[id(s)]: (m.numpy(), v.numpy())
            for s, (m, v) in stats.items()}
    got = [g[1]["bn"] for g in runs["got"]]
    assert set(got[0]) == set(want) and len(want) > 20
    for name, (mean, var) in want.items():
        for g in got:
            np.testing.assert_allclose(g[name][0], mean, atol=2e-4,
                                       rtol=2e-3, err_msg=name)
            np.testing.assert_allclose(g[name][1], var, atol=2e-4,
                                       rtol=2e-3, err_msg=name)
        np.testing.assert_array_equal(got[0][name][0], got[1][name][0])
