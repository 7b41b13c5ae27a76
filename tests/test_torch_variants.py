"""The Res16UNet variant family of the port against the JAX package's: the
registry, the backbone (BasicBlock and Bottleneck, reduced widths) in eval
and training mode, a BasicBlock variant through the whole model, the
Bottleneck model refused by both packages, the routing's B1 count and the
three pooling ops.

Weights cross through the reference state-dict layout. The JAX package's
export writes a Bottleneck's ``conv1``, ``conv2``, ``norm1``, ``norm2`` and
``downsample`` only (ROADMAP C3), so the tests add ``conv3`` and ``norm3``
from its parameter tree. Tolerances: the FPN maps and BatchNorm statistics
at ``tests/test_torch_model.py``'s and ``tests/test_torch_train.py``'s; the
masks at atol 1e-4 with both decoders fed the same scene features; the
pooling ops at atol 1e-6."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.models import backbone as pbackbone
from agile3d_torch.models.agile3d import Agile3D, ClickState, SceneFeatures
from agile3d_torch.models.backbone import (
    BACKBONE_VARIANTS,
    Res16UNet,
    backbone_config,
    banded_convs,
    commit_bn_stats,
    init_res16unet,
)
from agile3d_torch.ops import sparse_conv as psc
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.ckpt import (
    export_reference_state_dict,
    load_reference_state_dict,
)
from agile3d_tpu.config import BackboneConfig, ModelConfig
from agile3d_tpu.data.datasets import collate_scenes
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.models import backbone as jbackbone
from agile3d_tpu.ops import sparse_conv as jsc
from agile3d_tpu.ops.norm import BNState
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_model import FPN_TOL, port_model, randomized_weights
from tests.test_torch_model import small_scene
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-4, atol=1e-6)
REDUCED = {
    "basic": BackboneConfig(init_dim=16, planes=(16, 16, 32, 32, 48, 48, 48, 48),
                            layers=(1, 1, 1, 1, 1, 1, 2, 1)),
    "bottleneck": BackboneConfig(init_dim=16,
                                 planes=(8, 16, 16, 16, 16, 16, 8, 8),
                                 layers=(1, 2, 1, 1, 1, 1, 2, 1),
                                 block="bottleneck"),
}


def test_registry_equals_jax():
    assert list(BACKBONE_VARIANTS) == list(jbackbone.BACKBONE_VARIANTS)
    assert len(BACKBONE_VARIANTS) == 20
    for name, want in jbackbone.BACKBONE_VARIANTS.items():
        got = backbone_config(name)
        assert (tuple(got.layers), tuple(got.planes), got.block) == (
            tuple(want.layers), tuple(want.planes), want.block), name
        assert got.expansion == want.expansion
    assert backbone_config("Res16UNet34C") == pbackbone.BackboneConfig()


def _randomize_bn(tree, rng):
    """Random affine parameters and running statistics for every BatchNorm
    of a JAX backbone tree (so BN is not the identity)."""
    if isinstance(tree, BNState):
        c = tree.mean.shape[0]
        return BNState(
            mean=jnp.asarray(rng.standard_normal(c).astype(np.float32) * 0.05),
            var=jnp.asarray(0.5 + rng.random(c).astype(np.float32)))
    if isinstance(tree, dict) and set(tree) == {"scale", "bias"}:
        c = tree["scale"].shape[0]
        return {"scale": jnp.asarray(0.5 + rng.random(c).astype(np.float32)),
                "bias": jnp.asarray(
                    rng.standard_normal(c).astype(np.float32) * 0.1)}
    if isinstance(tree, dict):
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def reference_sd(params, buffers, jcfg, bn_state) -> dict:
    """The reference layout of a JAX model, the Bottleneck's ``conv3`` and
    ``norm3`` included (the JAX export leaves them out)."""
    sd = export_torch_state_dict(params, buffers, jcfg, bn_state)
    for stage in range(1, 9):
        for j, (p, s) in enumerate(zip(params["backbone"][f"block{stage}"],
                                       bn_state[f"block{stage}"])):
            if "conv3" not in p:
                continue
            pre = f"backbone.block{stage}.{j}"
            sd[f"{pre}.conv3.kernel"] = np.asarray(p["conv3"]["w"])
            sd[f"{pre}.norm3.bn.weight"] = np.asarray(p["norm3"]["scale"])
            sd[f"{pre}.norm3.bn.bias"] = np.asarray(p["norm3"]["bias"])
            sd[f"{pre}.norm3.bn.running_mean"] = np.asarray(s["norm3"].mean)
            sd[f"{pre}.norm3.bn.running_var"] = np.asarray(s["norm3"].var)
    return sd


def _backbone_sd(sd) -> dict:
    return {k[len("backbone."):]: v for k, v in sd.items()
            if k.startswith("backbone.")}


@pytest.fixture(scope="module")
def scene():
    jsample, psample = small_scene(9, n_points=2500)
    return collate_scenes([jsample]), port_collate([psample])


@pytest.fixture(scope="module", params=sorted(REDUCED))
def backbones(request):
    """(config, JAX params, JAX state, the port's Res16UNet) with the same
    random weights and BatchNorm."""
    bcfg = REDUCED[request.param]
    jcfg = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                       max_clicks=32, backbone=bcfg)
    params, buffers, bn_state = jmodel.init_agile3d(jax.random.PRNGKey(2),
                                                    jcfg)
    rng = np.random.default_rng(4)
    params = dict(params, backbone=_randomize_bn(params["backbone"], rng))
    bn_state = _randomize_bn(bn_state, rng)
    sd = reference_sd(params, buffers, jcfg, bn_state)
    net = Res16UNet(port_model_config(jcfg).backbone)
    load_reference_state_dict(net, _backbone_sd(sd))
    return request.param, jcfg, params, buffers, bn_state, net.eval()


@pytest.mark.parametrize("training", [False, True])
def test_backbone_matches_jax(scene, backbones, training):
    """The FPN maps; in training mode also the BatchNorm statistics that
    the forward commits."""
    jbatch, pbatch = scene
    block, jcfg, params, buffers, jstate, net = backbones
    if block == "bottleneck":
        assert net.block1[0].conv3.kernel.shape == (8, 32)
        assert net.block2[0].downsample is not None      # 32 -> 64
        assert net.block2[1].downsample is None          # 64 -> 64
    fmaps, new_state = jax.jit(lambda p, st, pyr, x: jbackbone.backbone_forward(
        p, st, pyr, x, training=training, cfg=jcfg.backbone))(
        params["backbone"], jstate, jbatch.pyramid, jnp.asarray(jbatch.feats))
    net = copy.deepcopy(net)  # the fixture's weights stay as they are
    bn_stats = {} if training else None
    with torch.no_grad():
        got = net(to_device(pbatch.pyramid, "cpu"),
                  torch.from_numpy(pbatch.feats), bn_stats)
    for lvl, g, w in zip((4, 3, 2, 1, 0), got, fmaps):
        n = jbatch.pyramid.levels[lvl].num_valid
        assert g.shape == np.asarray(w).shape, lvl
        np.testing.assert_allclose(g.numpy()[:n], np.asarray(w)[:n],
                                   **FPN_TOL, err_msg=f"level {lvl}")
        assert np.abs(g.numpy()[n:]).max(initial=0.0) == 0.0
    if not training:
        return
    commit_bn_stats(bn_stats)
    want = reference_sd(params, buffers, jcfg, new_state)
    n = 0
    for key, got_v in export_reference_state_dict(net).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_v, np.asarray(want[f"backbone.{key}"]),
                                       **BN_TOL, err_msg=key)
            n += 1
    assert n == 2 * len(bn_stats) > 0


def test_basic_variant_through_the_model(scene):
    """A reduced Res16UNet14D-shaped model (one block a stage, planes
    widening in the up path): scene features at the FPN tolerance, masks at
    atol 1e-4 with both decoders fed JAX's scene features."""
    jbatch, pbatch = scene
    jcfg = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                       max_clicks=32, backbone=REDUCED["basic"])
    sd, params, buffers, bn_state = randomized_weights(
        jcfg, 3, np.random.default_rng(5))
    model = port_model(jcfg, sd)
    want, _ = jax.jit(lambda *a: jmodel.forward_backbone(*a, cfg=jcfg))(
        params, buffers, bn_state, jbatch.pyramid, jnp.asarray(jbatch.feats),
        jnp.asarray(jbatch.raw), jnp.asarray(jbatch.sample_idx))
    inputs = (to_device(pbatch.pyramid, "cpu"),
              *(torch.from_numpy(a) for a in (pbatch.feats, pbatch.raw,
                                              pbatch.sample_idx)))
    with torch.no_grad():
        got = model.forward_backbone(*inputs)
    for name in SceneFeatures._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **FPN_TOL,
                                   err_msg=name)
    n_valid = int((jbatch.sample_idx[0] >= 0).sum())
    rows = np.random.default_rng(0).choice(n_valid, 5, replace=False)
    vox = np.full((1, 32), -1, np.int32)
    vox[0, :5] = rows
    obj = np.zeros((1, 32), np.int32)
    obj[0, :5] = jbatch.labels[0][rows]
    time = np.zeros((1, 32), np.int32)
    time[0, :5] = np.arange(5)
    num_obj = np.array([3], np.int32)
    jm = jmodel.forward_mask(params, buffers, want, jmodel.ClickState(
        jnp.asarray(vox), jnp.asarray(obj), jnp.asarray(time)),
        jnp.asarray(num_obj), cfg=jcfg)["pred_masks"]
    pscene = SceneFeatures(*(torch.from_numpy(np.array(getattr(want, f)))
                             for f in SceneFeatures._fields))
    with torch.no_grad():
        pm = model.forward_mask(pscene, ClickState(
            torch.from_numpy(vox), torch.from_numpy(obj),
            torch.from_numpy(time)), torch.from_numpy(num_obj))["pred_masks"]
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)


def test_both_packages_refuse_the_bottleneck_model(scene):
    jbatch, _ = scene
    jcfg = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                       max_clicks=32, backbone=REDUCED["bottleneck"])
    with pytest.raises(ValueError, match="lin_squeeze") as exc:
        Agile3D(port_model_config(jcfg))
    assert "agile3d_tpu/models/agile3d.py:117" in str(exc.value)
    params, buffers, bn_state = jmodel.init_agile3d(jax.random.PRNGKey(0),
                                                    jcfg)
    with pytest.raises(TypeError, match="dot_general"):
        jax.eval_shape(lambda: jmodel.forward_backbone(
            params, buffers, bn_state, jbatch.pyramid,
            jnp.asarray(jbatch.feats), jnp.asarray(jbatch.raw),
            jnp.asarray(jbatch.sample_idx), cfg=jcfg))


@pytest.mark.parametrize("name", ["Res16UNet14D", "Res16UNet50",
                                  "Res16UNet34A"])
def test_routing_sends_the_predicted_convs_to_b1(scene, monkeypatch, name):
    """Forced onto the kernels' route (rows threshold 0, the CPU taking the
    plain versions), each variant at full width sends to B1 the k3 convs
    that ``banded_convs`` counts: per conv, by its input width."""
    _, pbatch = scene
    seen = []
    banded = pbackbone.BandedConv

    class Counting(banded):
        @staticmethod
        def forward(ctx, x, k3, w):
            seen.append((x.shape[1], w.shape[2]))
            return banded.forward(ctx, x, k3, w)

    monkeypatch.setattr(pbackbone, "BandedConv", Counting)
    monkeypatch.setattr(pbackbone, "BANDED_MIN_ROWS", 0)
    cfg = dataclasses.replace(backbone_config(name), banded_conv=True)
    net = init_res16unet(cfg, seed=0, device="cpu")
    with torch.no_grad():
        out = net(to_device(pbatch.pyramid, "cpu"),
                  torch.from_numpy(pbatch.feats))
    assert len(seen) == banded_convs(cfg)
    assert all(cin >= pbackbone.BANDED_MIN_CIN for cin, _ in seen)
    assert out[-1].shape[1] == cfg.planes[7] * cfg.expansion
    expected = {"Res16UNet14D": [(416, 384), (384, 384)] * 2,
                "Res16UNet50": [(256, 256)] * 4,
                "Res16UNet34A": [(96, 64)] * 2}[name]
    assert seen == expected


@pytest.mark.parametrize("op", ["avg_pool_down", "sum_pool_down",
                                "avg_unpool_up"])
def test_pooling_ops_match_jax(scene, op):
    jbatch, pbatch = scene
    rng = np.random.default_rng(1)
    for lv in range(len(pbatch.pyramid.levels) - 1):
        fine, coarse = pbatch.pyramid.levels[lv], pbatch.pyramid.levels[lv + 1]
        if op == "avg_unpool_up":
            x = rng.standard_normal((coarse.grid.shape[0], 5)).astype(np.float32)
            idx = fine.up_parent
        else:
            x = rng.standard_normal((fine.grid.shape[0], 5)).astype(np.float32)
            idx = fine.down
        got = getattr(psc, op)(torch.from_numpy(x), torch.from_numpy(idx))
        want = getattr(jsc, op)(jnp.asarray(x), jnp.asarray(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=f"{op}, level {lv}")
