"""The port's model against the JAX package's at a reduced width: every FPN
level of the backbone, the scene features of ``forward_backbone`` and the
masks of ``forward_mask``, at f32 on the CPU with the same weights (crossed
through the reference state-dict layout) and the same host-built inputs.

Tolerances: the FPN maps at the existing backbone parity test's
(rtol 5e-4, atol 2e-4: two f32 gather-GEMMs summing in different orders
through 27 layers); the decoder's masks at atol 1e-4 when both decoders get
the same scene features."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.data.datasets import SceneSample as PortSample
from agile3d_torch.models.agile3d import Agile3D, ClickState, SceneFeatures
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.ckpt import load_reference_state_dict
from agile3d_tpu.config import BackboneConfig, ModelConfig
from agile3d_tpu.data.datasets import SceneSample, collate_scenes
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.models.backbone import backbone_forward
from agile3d_tpu.sparse.quantize import sparse_quantize
from agile3d_tpu.utils.ckpt import convert_torch_state_dict, export_torch_state_dict
from tests.synthetic import make_scene
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

# a few layers, narrow widths: JAX's CPU compile stays short
SMALL = ModelConfig(
    hidden_dim=32, dim_feedforward=64, num_heads=4, max_clicks=32,
    backbone=BackboneConfig(init_dim=16, planes=(16, 16, 32, 32, 32, 32, 32, 32),
                            layers=(1,) * 8))
FPN_TOL = dict(rtol=5e-4, atol=2e-4)


def randomized_weights(jcfg: ModelConfig, seed: int, rng):
    """JAX init at ``seed``, exported to the reference layout, with random
    BatchNorm affine and running statistics (so BN is not the identity),
    converted back. Returns (state dict, params, buffers, bn_state)."""
    params, buffers, bn_state = jmodel.init_agile3d(jax.random.PRNGKey(seed),
                                                    jcfg)
    sd = export_torch_state_dict(params, buffers, jcfg, bn_state)
    for k in list(sd):
        if k.endswith(".bn.weight"):
            c = sd[k].shape[0]
            sd[k] = 0.5 + rng.random(c).astype(np.float32)
            sd[k[:-6] + "bias"] = rng.standard_normal(c).astype(np.float32) * 0.1
            sd[k[:-9] + "running_mean"] = (
                rng.standard_normal(c).astype(np.float32) * 0.05)
            sd[k[:-9] + "running_var"] = 0.5 + rng.random(c).astype(np.float32)
    params, buffers, bn_state = convert_torch_state_dict(sd, jcfg)
    return sd, params, buffers, bn_state


def port_model(jcfg: ModelConfig, sd) -> Agile3D:
    model = Agile3D(port_model_config(jcfg))
    load_reference_state_dict(model, sd)
    return model.eval()


def small_scene(seed: int, n_points: int = 1500, num_obj: int = 3):
    """One scene quantized once, as a JAX SceneSample and the port's."""
    rng = np.random.default_rng(seed)
    coords, colors, labels = make_scene(rng, n_points=n_points, num_obj=num_obj)
    coords = coords - coords.min(axis=0, keepdims=True)
    vox, umap, imap = sparse_quantize(coords, 0.05)
    fields = dict(vox_coords=vox, raw_coords=coords[umap],
                  feats=colors[umap].astype(np.float32) / 255.0,
                  labels=labels[umap], labels_full=labels, inverse_map=imap,
                  click_idx={}, scene_name="scene0000_00", num_obj=num_obj)
    return SceneSample(**fields), PortSample(**fields)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    sd, params, buffers, bn_state = randomized_weights(SMALL, 3, rng)
    jsample, psample = small_scene(9)
    jbatch = collate_scenes([jsample])
    pbatch = port_collate([psample])
    assert pbatch.pyramid.levels[0].grid.shape[0] == 2048
    model = port_model(SMALL, sd)
    scene, _ = jax.jit(lambda *a: jmodel.forward_backbone(*a, cfg=SMALL))(
        params, buffers, bn_state, jbatch.pyramid, jnp.asarray(jbatch.feats),
        jnp.asarray(jbatch.raw), jnp.asarray(jbatch.sample_idx))
    return dict(params=params, buffers=buffers, bn_state=bn_state,
                jbatch=jbatch, pbatch=pbatch, model=model, scene=scene)


def _port_inputs(s):
    b = s["pbatch"]
    return (to_device(b.pyramid, "cpu"), torch.from_numpy(b.feats),
            torch.from_numpy(b.raw), torch.from_numpy(b.sample_idx))


def test_backbone_fpn_levels_match_jax(setup):
    s = setup
    b = s["jbatch"]
    fmaps, _ = jax.jit(lambda p, st, pyr, x: backbone_forward(
        p, st, pyr, x, training=False, cfg=SMALL.backbone))(
        s["params"]["backbone"], s["bn_state"], b.pyramid,
        jnp.asarray(b.feats))
    pyr, feats, _, _ = _port_inputs(s)
    with torch.no_grad():
        got = s["model"].backbone(pyr, feats)
    assert len(got) == len(fmaps) == 5
    for lvl, g, w in zip((4, 3, 2, 1, 0), got, fmaps):
        n = b.pyramid.levels[lvl].num_valid
        g = g.numpy()
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g[:n], np.asarray(w)[:n], **FPN_TOL,
                                   err_msg=f"level {lvl}")
        assert np.abs(g[n:]).max(initial=0.0) == 0.0, f"pad rows, level {lvl}"


def test_scene_features_match_jax(setup):
    s = setup
    want = s["scene"]
    with torch.no_grad():
        got = s["model"].forward_backbone(*_port_inputs(s))
    for name in SceneFeatures._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **FPN_TOL,
                                   err_msg=name)
    n = int(got.vox_valid.sum())
    assert np.abs(got.mask_feat[0, n:].numpy()).max() == 0.0
    assert np.abs(got.pos_pcd[0, n:].numpy()).max() == 0.0


def _clicks(n_valid, labels, rng, count=7, mc=32):
    vox = np.full((1, mc), -1, np.int32)
    obj = np.zeros((1, mc), np.int32)
    time = np.zeros((1, mc), np.int32)
    rows = rng.choice(n_valid, size=count, replace=False)
    vox[0, :count] = rows
    obj[0, :count] = labels[rows]
    time[0, :count] = np.arange(count)
    return vox, obj, time


@pytest.mark.parametrize("count", [3, 7])
def test_forward_mask_matches_jax(setup, count):
    """Both decoders read the JAX scene features, so the comparison holds
    the decoder alone to atol 1e-4."""
    s = setup
    scene = s["scene"]
    b = s["jbatch"]
    n_valid = int((b.sample_idx[0] >= 0).sum())
    vox, obj, time = _clicks(n_valid, b.labels[0], np.random.default_rng(count),
                             count)
    num_obj = np.array([3], np.int32)
    want = jax.jit(lambda p, bu, sc, c, no: jmodel.forward_mask(
        p, bu, sc, c, no, cfg=SMALL))(
        s["params"], s["buffers"], scene,
        jmodel.ClickState(jnp.asarray(vox), jnp.asarray(obj), jnp.asarray(time)),
        jnp.asarray(num_obj))

    pscene = SceneFeatures(*(torch.from_numpy(np.array(getattr(scene, f)))
                             for f in SceneFeatures._fields))
    clicks = ClickState(torch.from_numpy(vox), torch.from_numpy(obj),
                        torch.from_numpy(time))
    with torch.no_grad():
        got = s["model"].forward_mask(pscene, clicks, torch.from_numpy(num_obj))
    for key in ("pred_masks", "aux_masks"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
    pred = got["pred_masks"][0].argmax(-1).numpy()
    np.testing.assert_array_equal(
        pred[:n_valid], np.asarray(want["pred_masks"][0]).argmax(-1)[:n_valid])


def test_end_to_end_labels_agree(setup):
    """Port backbone + port decoder against JAX backbone + JAX decoder: the
    masks agree to the FPN tolerance scaled by the logits, and the argmax
    labels agree on all but a sliver of near-tie voxels."""
    s = setup
    scene = s["scene"]
    b = s["jbatch"]
    n_valid = int((b.sample_idx[0] >= 0).sum())
    vox, obj, time = _clicks(n_valid, b.labels[0], np.random.default_rng(1))
    num_obj = np.array([3], np.int32)
    want = jmodel.forward_mask(
        s["params"], s["buffers"], scene,
        jmodel.ClickState(jnp.asarray(vox), jnp.asarray(obj), jnp.asarray(time)),
        jnp.asarray(num_obj), cfg=SMALL)["pred_masks"]
    with torch.no_grad():
        pscene = s["model"].forward_backbone(*_port_inputs(s))
        got = s["model"].forward_mask(
            pscene, ClickState(torch.from_numpy(vox), torch.from_numpy(obj),
                               torch.from_numpy(time)),
            torch.from_numpy(num_obj))["pred_masks"].numpy()
    want = np.asarray(want)
    live = want[0, :n_valid, :4]
    scale = float(np.abs(live).max()) + 1.0
    np.testing.assert_allclose(got[0, :n_valid, :4], live, rtol=0,
                               atol=1e-3 * scale)
    agree = (got[0, :n_valid].argmax(-1) == want[0, :n_valid].argmax(-1)).mean()
    assert agree >= 0.999, agree


def test_config_mapping_keeps_shared_fields():
    pc = port_model_config(SMALL)
    for f in dataclasses.fields(pc):
        if f.name != "backbone":
            assert getattr(pc, f.name) == getattr(SMALL, f.name), f.name
    assert tuple(pc.backbone.planes) == tuple(SMALL.backbone.planes)
