"""The port's voxel-sharded decoder (``agile3d_torch/parallel/sp.py``) on
spawned ``gloo`` groups of 2 and 4 ranks against the JAX package's
one-process ``forward_mask`` on the CPU, with the same weights (crossed
through the reference state-dict layout) and the same scene.

Cases: the JAX tests' scene (``tests/test_parallel.py::_scene_and_clicks``,
600 valid of 1,024 rows, the decoder at full width; the backbone, which
the decoder does not read, at a few layers) dense, with two hlevels slots
and two decoders, and with the bf16 decoder; and a scene of 24,576 rows a
rank on the reduced decoder of ``tests/test_torch_model.py``, where each
rank picks chunked attention from its own rows. Tolerances: the JAX SP
tests' 2e-3 (rtol and atol) with argmax equal; bf16 as the one-process
bf16 decoder is held (``tests/test_torch_decoder.py``): within 2e-2 x
(max |logit| + 1) of JAX's bf16 pass, labels equal on >= 99% of the rows.
The dense case is also held against JAX's ``make_forward_mask_sp`` on a
mesh of as many CPU devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agile3d_tpu.config import BackboneConfig, ModelConfig
from agile3d_tpu.models.agile3d import (
    ClickState,
    SceneFeatures,
    forward_mask,
    init_agile3d,
)
from agile3d_tpu.ops.pos_enc import fourier_pos
from agile3d_tpu.parallel import make_mesh
from agile3d_tpu.parallel.sp import make_forward_mask_sp
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from agile3d_torch.models.agile3d import _pick_attn_chunk
from agile3d_torch.parallel.mesh import spawn
from tests import torch_parallel_ranks as ranks
from tests.test_parallel import _scene_and_clicks
from tests.test_torch_model import SMALL
from tests.test_torch_weights import port_model_config

TINY_BB = BackboneConfig(init_dim=8, planes=(8,) * 8, layers=(1,) * 8)
FULL = ModelConfig(max_clicks=32, backbone=TINY_BB)
CASES = {
    "dense": (FULL, 0, 600, 1024),
    "hlevels": (dataclasses.replace(FULL, hlevels=(4, 4), num_decoders=2),
                1, 600, 1024),
    "bf16": (dataclasses.replace(FULL, decoder_dtype="bfloat16"), 2, 600,
             1024),
    # 24,576 rows a rank: 6 chunks of 4,096 rows in each rank
    "chunked": (dataclasses.replace(SMALL, xla_attn_dense_threshold=0), 3,
                None, 24576),
}
NUM_OBJ = np.array([3], np.int32)


def _scene_and_clicks_of_width(rng, n_valid, n_pad, cfg):
    """``tests/test_parallel.py::_scene_and_clicks`` at ``cfg``'s width."""
    params, buffers, _ = init_agile3d(jax.random.PRNGKey(0), cfg)
    raw = rng.random((n_pad, 3)).astype(np.float32) * 5
    raw[n_valid:] = 0
    feat = rng.standard_normal((n_pad, cfg.hidden_dim)).astype(
        np.float32) * 0.5
    feat[n_valid:] = 0
    valid = np.zeros(n_pad, bool)
    valid[:n_valid] = True
    cmin, cmax = raw[:n_valid].min(0), raw[:n_valid].max(0)
    pos = np.array(fourier_pos(jnp.asarray(raw), buffers["gauss_B"],
                               jnp.asarray(cmin), jnp.asarray(cmax)))
    pos[~valid] = 0
    scene = SceneFeatures(*(jnp.asarray(a)[None] for a in (
        feat, pos, valid, raw, cmin, cmax)))
    vox = np.full((1, cfg.max_clicks), -1, np.int32)
    obj = np.zeros((1, cfg.max_clicks), np.int32)
    tim = np.zeros((1, cfg.max_clicks), np.int32)
    picks = rng.choice(n_valid, 7, replace=False)
    for i, (v, o) in enumerate(zip(picks, [1, 1, 2, 3, 0, 2, 1])):
        vox[0, i], obj[0, i], tim[0, i] = v, o, i
    return params, buffers, scene, ClickState(*map(jnp.asarray,
                                                   (vox, obj, tim)))


def _case(jcfg, seed, n_valid, n_pad, world):
    if n_valid is None:
        n_pad *= world
        n_valid = n_pad * 3 // 5
    rng = np.random.default_rng(seed)
    if jcfg.hidden_dim == 128:
        params, buffers, scene, clicks = _scene_and_clicks(
            rng, n_valid=n_valid, n_pad=n_pad, cfg=jcfg)
    else:
        params, buffers, scene, clicks = _scene_and_clicks_of_width(
            rng, n_valid, n_pad, jcfg)
    _, _, bn_state = init_agile3d(jax.random.PRNGKey(0), jcfg)
    sd = export_torch_state_dict(params, buffers, jcfg, bn_state)
    want = jax.jit(lambda p, b, s, c, n: forward_mask(p, b, s, c, n,
                                                      cfg=jcfg))(
        params, buffers, scene, clicks, jnp.asarray(NUM_OBJ))
    arrays = tuple(np.asarray(a) for a in scene)
    return dict(jcfg=jcfg, params=params, buffers=buffers, scene=scene,
                clicks=clicks, sd=sd, arrays=arrays,
                click_arrays=tuple(np.asarray(c) for c in clicks),
                want=np.asarray(want["all_masks"]))


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def runs(request):
    world = request.param
    cases = {k: _case(*v, world) for k, v in CASES.items()}
    args = [(port_model_config(c["jcfg"]), c["sd"], c["arrays"],
             c["click_arrays"], NUM_OBJ) for c in cases.values()]
    got = spawn(ranks.sp_decoder_cases, world, args, device="cpu")
    for i, c in enumerate(cases.values()):
        # the ranks' rows in rank order
        c["got"] = np.concatenate([g[i] for g in got], axis=2)
    return world, cases


def _valid(c):
    return c["arrays"][2][0]


@pytest.mark.parametrize("name", ["dense", "hlevels", "chunked"])
def test_sp_decoder_matches_jax(runs, name):
    world, cases = runs
    c = cases[name]
    v = _valid(c)
    assert c["got"].shape == c["want"].shape
    a = c["want"][:, 0][:, v][..., :4]
    b = c["got"][:, 0][:, v][..., :4]
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(c["got"][-1, 0, v].argmax(-1),
                                  c["want"][-1, 0, v].argmax(-1))
    if name == "hlevels":
        assert c["got"].shape[0] == 4   # 2 decoders x 2 slots
    nl = c["arrays"][0].shape[1] // world
    cfg = port_model_config(c["jcfg"])
    q = cfg.num_bg_queries + cfg.max_clicks
    chunk = _pick_attn_chunk(nl, q * nl * cfg.num_heads, cfg)
    assert chunk == (4096 if name == "chunked" else 0)


def test_sp_decoder_bf16_matches_jax(runs):
    _, cases = runs
    c = cases["bf16"]
    v = _valid(c)
    g = c["got"][-1, 0, v, :4]
    w = c["want"][-1, 0, v, :4]
    scale = float(np.abs(w).max()) + 1.0
    np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * scale)
    assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.99


def test_sp_decoder_matches_jax_sp(runs):
    """The dense case against JAX's own voxel-sharded decoder on a mesh of
    as many CPU devices."""
    world, cases = runs
    c = cases["dense"]
    fm, shard = make_forward_mask_sp(make_mesh(n_dp=1, n_sp=world),
                                     c["jcfg"])
    want = np.asarray(fm(c["params"], c["buffers"], shard(c["scene"]),
                         c["clicks"], jnp.asarray(NUM_OBJ))["all_masks"])
    v = _valid(c)
    np.testing.assert_allclose(c["got"][:, 0][:, v][..., :4],
                               want[:, 0][:, v][..., :4], rtol=2e-3,
                               atol=2e-3)
