"""The port's decoder policies against the JAX package's: the chunked
attention forms (values and gradients), the chunk choice, each key chunk's
bias, ``forward_mask`` with chunking engaged (against JAX, against the
port's own dense path, and its gradients under autograd with per-round
checkpointing), and the bf16 decoder policy.

Inputs are made from seeds with numpy and given to both packages; weights
cross through the reference state-dict layout. Tolerances: attention and
the f32 decoder at atol 1e-4 (f32 summed in other orders); gradients at
rtol 2e-3 / atol 1e-4, the JAX package's own chunked-gradient bound
(``tests/test_chunked_attention.py``); bf16 masks within 2e-2 x (max|logit|
+ 1) with argmax agreement >= 0.99 against JAX and >= 0.90 against the
port's f32 decoder (``tests/test_compact_bias.py``'s bound)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.models import agile3d as pmodel
from agile3d_torch.models.agile3d import Agile3D, ClickState, SceneFeatures
from agile3d_torch.ops import attention as pattn
from agile3d_torch.utils.ckpt import load_reference_state_dict
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.ops import attention as jattn
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_model import SMALL, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

HEADS = 4
ATOL = 1e-4
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)


def _mha_weights(e, seed):
    """JAX ``init_mha`` params with random biases, and the port's packed
    layout of the same numbers."""
    params = jattn.init_mha(jax.random.PRNGKey(seed), e)
    rng = np.random.default_rng(seed)
    for k in ("q_b", "k_b", "v_b", "out_b"):
        params[k] = jnp.asarray(rng.standard_normal(e).astype(np.float32) * 0.1)
    t = lambda a: torch.from_numpy(np.array(a))
    port = [t(np.concatenate([np.asarray(params[k]).T
                              for k in ("q_w", "k_w", "v_w")])),
            t(np.concatenate([np.asarray(params[k])
                              for k in ("q_b", "k_b", "v_b")])),
            t(np.asarray(params["out_w"]).T), t(params["out_b"])]
    return params, port


def _inputs(rng, b, lq, lk, e):
    q = rng.standard_normal((b, lq, e)).astype(np.float32)
    k = rng.standard_normal((b, lk, e)).astype(np.float32)
    v = rng.standard_normal((b, lk, e)).astype(np.float32)
    return q, k, v


def _bias(rng, b, rows, lk):
    return np.where(rng.random((b, rows, lk)) < 0.2, -1e9, 0.0).astype(
        np.float32)


@pytest.mark.parametrize("bias", ["full", "fn", "none"])
def test_chunked_keys_matches_jax(bias):
    rng = np.random.default_rng(0)
    params, port = _mha_weights(32, 0)
    q, k, v = _inputs(rng, 2, 12, 512, 32)
    full = _bias(rng, 2, 12, 512)
    jb = jnp.asarray(full)
    jkw = {"full": dict(attn_bias=jb),
           "fn": dict(bias_fn=lambda s, n: jax.lax.dynamic_slice_in_dim(
               jb, s, n, axis=2)),
           "none": {}}[bias]
    tb = torch.from_numpy(full)
    pkw = {"full": dict(attn_bias=tb),
           "fn": dict(bias_fn=lambda s, n: tb[:, :, s:s + n]),
           "none": {}}[bias]
    want = jattn.mha_chunked_keys(params, *map(jnp.asarray, (q, k, v)),
                                  HEADS, chunk=128, **jkw)
    got = pattn.mha_chunked_keys(*map(torch.from_numpy, (q, k, v)), HEADS,
                                 *port, chunk=128, **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    dense = pattn.mha(*map(torch.from_numpy, (q, k, v)), HEADS, *port,
                      None if bias == "none" else tb)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("bias", ["full", "row", "none"])
def test_chunked_queries_matches_jax(bias):
    """[B, Lq, Lk] per-query bias, the [B, 1, Lk] key row shared by every
    query (the scene-to-click direction's form), and no bias."""
    rng = np.random.default_rng(1)
    params, port = _mha_weights(32, 1)
    q, k, v = _inputs(rng, 2, 512, 24, 32)
    arr = {"full": _bias(rng, 2, 512, 24), "row": _bias(rng, 2, 1, 24),
           "none": None}[bias]
    want = jattn.mha_chunked_queries(
        params, *map(jnp.asarray, (q, k, v)), HEADS,
        None if arr is None else jnp.asarray(arr), chunk=128)
    tb = None if arr is None else torch.from_numpy(arr)
    got = pattn.mha_chunked_queries(*map(torch.from_numpy, (q, k, v)), HEADS,
                                    *port, tb, chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("form", ["keys", "keys_fn", "queries"])
def test_non_dividing_chunk_falls_back_to_dense(form):
    """An axis of 300 rows and a chunk of 128: both packages run dense
    ``mha``, the key form with ``bias_fn(0, lk)`` when one is given."""
    rng = np.random.default_rng(2)
    params, port = _mha_weights(32, 2)
    lq, lk = (12, 300) if form != "queries" else (300, 24)
    q, k, v = _inputs(rng, 2, lq, lk, 32)
    arr = _bias(rng, 2, lq, lk)
    jb, tb = jnp.asarray(arr), torch.from_numpy(arr)
    calls = []
    if form == "queries":
        want = jattn.mha_chunked_queries(params, *map(jnp.asarray, (q, k, v)),
                                         HEADS, jb, chunk=128)
        got = pattn.mha_chunked_queries(*map(torch.from_numpy, (q, k, v)),
                                        HEADS, *port, tb, chunk=128)
    else:
        jkw = (dict(bias_fn=lambda s, n: jb[:, :, s:s + n])
               if form == "keys_fn" else dict(attn_bias=jb))
        pkw = (dict(bias_fn=lambda s, n: calls.append((s, n))
                    or tb[:, :, s:s + n])
               if form == "keys_fn" else dict(attn_bias=tb))
        want = jattn.mha_chunked_keys(params, *map(jnp.asarray, (q, k, v)),
                                      HEADS, chunk=128, **jkw)
        got = pattn.mha_chunked_keys(*map(torch.from_numpy, (q, k, v)),
                                     HEADS, *port, chunk=128, **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    dense = pattn.mha(*map(torch.from_numpy, (q, k, v)), HEADS, *port, tb)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    assert calls == ([(0, lk)] if form == "keys_fn" else [])


@pytest.mark.parametrize("bias", ["full", "fn"])
def test_chunked_keys_gradients_match_jax(bias):
    """Gradients of the inputs and of every weight through the key-chunked
    form against ``jax.grad`` of the same loss."""
    rng = np.random.default_rng(3)
    params, port = _mha_weights(32, 3)
    q, k, v = _inputs(rng, 1, 8, 256, 32)
    arr = _bias(rng, 1, 8, 256)
    jb, tb = jnp.asarray(arr), torch.from_numpy(arr)
    cot = rng.standard_normal((1, 8, 32)).astype(np.float32)

    def jloss(p, q, k, v):
        kw = (dict(bias_fn=lambda s, n: jax.lax.dynamic_slice_in_dim(
            jb, s, n, axis=2)) if bias == "fn" else dict(attn_bias=jb))
        out = jattn.mha_chunked_keys(p, q, k, v, HEADS, chunk=64, **kw)
        return jnp.sum(out * cot)

    gp, gq, gk, gv = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        params, *map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ws = [w.clone().requires_grad_() for w in port]
    kw = (dict(bias_fn=lambda s, n: tb[:, :, s:s + n]) if bias == "fn"
          else dict(attn_bias=tb))
    out = pattn.mha_chunked_keys(*xs, HEADS, *ws, chunk=64, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in zip(xs, (gq, gk, gv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    want_w = [np.concatenate([np.asarray(gp[k]).T
                              for k in ("q_w", "k_w", "v_w")]),
              np.concatenate([np.asarray(gp[k])
                              for k in ("q_b", "k_b", "v_b")]),
              np.asarray(gp["out_w"]).T, np.asarray(gp["out_b"])]
    for got, want in zip(ws, want_w):
        np.testing.assert_allclose(got.grad.numpy(), want, **GRAD_TOL)


def test_pick_attn_chunk_matches_jax():
    ns = [2048, 4096, 24576, 32768, 49152, 65536, 98304, 131072, 196608,
          262144, 393216, 524288, 786432, 1048576, 73728, 100000, 1056768]
    volumes = [0, 9_999_999, 10_000_000, 10_000_001, 66_060_288, 10 ** 9]
    cfgs = [dict(), dict(xla_attn_chunk=0), dict(xla_attn_chunk=16384),
            dict(xla_attn_chunk=8192, xla_attn_dense_threshold=0),
            dict(xla_attn_dense_threshold=50_000_000)]
    picked = set()
    for kw in cfgs:
        jcfg = dataclasses.replace(SMALL, **kw)
        pcfg = port_model_config(jcfg)
        for n in ns:
            for vol in volumes:
                want = jmodel._pick_attn_chunk(n, vol, jcfg)
                assert pmodel._pick_attn_chunk(n, vol, pcfg) == want, \
                    (kw, n, vol)
                picked.add(want)
    assert {0, 4096, 8192, 16384, 32768} <= picked
    # the smoke scene and the training batch of chip_smoke.py
    cfg = port_model_config(SMALL)
    assert pmodel._pick_attn_chunk(196608, 8 * 42 * 196608, cfg) == 32768
    assert pmodel._pick_attn_chunk(98304, 5 * 74 * 98304 * 8, cfg) == 16384


def _compact_state(rng, b=2, q=14, n=8192, n_cols=11):
    labels = rng.integers(-1, 4, (b, n)).astype(np.int32)
    present = rng.random((b, n_cols)) < 0.5
    safe_obj = rng.integers(0, n_cols, (b, q)).astype(np.int32)
    vox_valid = rng.random((b, n)) < 0.9
    return labels, present, safe_obj, vox_valid


def test_round_bias_chunk_matches_jax():
    """Each key chunk's bias equals JAX's ``_round_bias_chunk`` slice and
    the same slice of the port's dense [B, Q, N] bias."""
    arrays = _compact_state(np.random.default_rng(4))
    jfn = jmodel._round_bias_chunk(*map(jnp.asarray, arrays))
    t = [torch.from_numpy(a) for a in arrays]
    t[0], t[2] = t[0].long(), t[2].long()
    pfn = pmodel._round_bias_chunk(*t)
    dense = Agile3D._round_bias_dense(*t)
    for start in (0, 2048, 4096, 6144):
        got = pfn(start, 2048)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jfn(start, 2048)))
        np.testing.assert_array_equal(got.numpy(),
                                      dense[:, :, start:start + 2048].numpy())


# ---------------------------------------------------------------------------
# forward_mask with chunking engaged: SceneFeatures built directly at the
# 24,576-row bucket (JAX's smallest chunk is 4,096: 6 chunks), no backbone
# ---------------------------------------------------------------------------

N_ROWS, N_VALID, NUM_OBJ = 24576, 15000, 3
# dense below a logits volume of 0: every pass chunks; "dense": never
CHUNKED = dataclasses.replace(SMALL, xla_attn_dense_threshold=0)
DENSE = dataclasses.replace(SMALL, xla_attn_dense_threshold=10 ** 12)


def _scene_arrays(seed):
    rng = np.random.default_rng(seed)
    c = SMALL.hidden_dim
    valid = np.zeros((1, N_ROWS), bool)
    valid[0, :N_VALID] = True
    mask_feat = rng.standard_normal((1, N_ROWS, c)).astype(np.float32)
    pos_pcd = rng.uniform(-1, 1, (1, N_ROWS, c)).astype(np.float32)
    raw = rng.uniform(0, 4, (1, N_ROWS, 3)).astype(np.float32)
    for a in (mask_feat, pos_pcd, raw):
        a[~valid] = 0.0
    cmin = raw[0, :N_VALID].min(0)[None]
    cmax = raw[0, :N_VALID].max(0)[None]
    labels = rng.integers(0, NUM_OBJ + 1, N_VALID)
    mc, count = 32, 9
    vox = np.full((1, mc), -1, np.int32)
    obj = np.zeros((1, mc), np.int32)
    rows = rng.choice(N_VALID, count, replace=False)
    vox[0, :count] = rows
    obj[0, :count] = labels[rows]
    tim = np.tile(np.arange(mc, dtype=np.int32), (1, 1))
    scene = (mask_feat, pos_pcd, valid, raw, cmin, cmax)
    return scene, (vox, obj, tim), np.array([NUM_OBJ], np.int32)


@pytest.fixture(scope="module")
def decoder():
    sd, params, buffers, bn_state = randomized_weights(
        SMALL, 7, np.random.default_rng(7))
    scene, clicks, num_obj = _scene_arrays(8)
    return dict(sd=sd, params=params,
                buffers=jax.tree_util.tree_map(jnp.asarray, buffers),
                bn_state=bn_state, scene=scene, clicks=clicks,
                num_obj=num_obj)


def _port(d, jcfg, **kw):
    model = Agile3D(dataclasses.replace(port_model_config(jcfg), **kw))
    load_reference_state_dict(model, d["sd"])
    return model.eval()


def _port_inputs(d):
    scene = SceneFeatures(*map(torch.from_numpy, d["scene"]))
    clicks = ClickState(*map(torch.from_numpy, d["clicks"]))
    return scene, clicks, torch.from_numpy(d["num_obj"])


def _jax_forward(d, jcfg):
    scene = jmodel.SceneFeatures(*map(jnp.asarray, d["scene"]))
    clicks = jmodel.ClickState(*map(jnp.asarray, d["clicks"]))
    return jax.jit(lambda p, b, s, c, n: jmodel.forward_mask(
        p, b, s, c, n, cfg=jcfg))(d["params"], d["buffers"], scene, clicks,
                                  jnp.asarray(d["num_obj"]))


@pytest.fixture(scope="module")
def chunked_runs(decoder):
    d = decoder
    want = _jax_forward(d, CHUNKED)
    with torch.no_grad():
        got = _port(d, CHUNKED).forward_mask(*_port_inputs(d))
        dense = _port(d, DENSE).forward_mask(*_port_inputs(d))
    return want, got, dense


def test_forward_mask_chunked_matches_jax(chunked_runs):
    want, got, _ = chunked_runs
    assert got["attn_chunk"] == 4096
    for key in ("pred_masks", "aux_masks"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)


def test_forward_mask_chunked_matches_dense(chunked_runs):
    _, got, dense = chunked_runs
    assert dense["attn_chunk"] == 0
    for key in ("pred_masks", "aux_masks"):
        np.testing.assert_allclose(got[key].numpy(), dense[key].numpy(),
                                   rtol=0, atol=ATOL, err_msg=key)


def test_forward_mask_chunked_gradients_match_jax(decoder):
    """One training-mode pass: gradients of a fixed linear loss on every
    round's masks, to the scene features and to every decoder weight,
    through the chunked attention under per-round checkpointing, against
    ``jax.grad`` (JAX's rounds under jax.checkpoint)."""
    d = decoder
    cot = np.random.default_rng(9).standard_normal(
        (SMALL.num_decoders, 1, N_VALID, NUM_OBJ + 1)).astype(np.float32)

    def jloss(params, mask_feat, pos_pcd):
        scene = jmodel.SceneFeatures(
            mask_feat, pos_pcd, *map(jnp.asarray, d["scene"][2:]))
        out = jmodel.forward_mask(
            params, d["buffers"], scene,
            jmodel.ClickState(*map(jnp.asarray, d["clicks"])),
            jnp.asarray(d["num_obj"]), cfg=CHUNKED)
        return jnp.sum(out["all_masks"][:, :, :N_VALID, :NUM_OBJ + 1] * cot)

    gp, gmf, gpp = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        d["params"], *map(jnp.asarray, d["scene"][:2]))
    want = export_torch_state_dict(gp, d["buffers"], SMALL, d["bn_state"])

    model = _port(d, CHUNKED).train()
    scene, clicks, num_obj = _port_inputs(d)
    mf = scene.mask_feat.clone().requires_grad_()
    pp = scene.pos_pcd.clone().requires_grad_()
    with torch.enable_grad():
        out = model.forward_mask(scene._replace(mask_feat=mf, pos_pcd=pp),
                                 clicks, num_obj)
        assert out["attn_chunk"] == 4096
        (out["all_masks"][:, :, :N_VALID, :NUM_OBJ + 1]
         * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(mf.grad.numpy(), np.asarray(gmf), **GRAD_TOL)
    np.testing.assert_allclose(pp.grad.numpy(), np.asarray(gpp), **GRAD_TOL)
    n_checked = 0
    for name, p in model.named_parameters():
        if name.startswith(("backbone.", "lin_squeeze_head.")):
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)
        n_checked += 1
    assert n_checked > 40


# ---------------------------------------------------------------------------
# the bf16 decoder policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["dense", "chunked"])
def test_bf16_decoder_matches_jax(decoder, form):
    """One ``forward_mask`` pass with decoder_dtype="bfloat16" in both
    packages (on the CPU): masks within 2e-2 x (max|logit| + 1), argmax
    agreement >= 0.99 on valid rows, f32 outputs, and >= 0.90 agreement
    with the port's f32 decoder. No byte-for-byte trajectory is compared:
    two frameworks' bf16 roundings differ, and rollouts at random weights
    amplify any difference (tests/test_golden.py)."""
    d = decoder
    jcfg = dataclasses.replace(CHUNKED if form == "chunked" else DENSE,
                               decoder_dtype="bfloat16")
    want = np.asarray(_jax_forward(d, jcfg)["pred_masks"])
    with torch.no_grad():
        model = _port(d, jcfg)
        out = model.forward_mask(*_port_inputs(d))
        f32 = _port(d, jcfg, decoder_dtype="float32").forward_mask(
            *_port_inputs(d))["pred_masks"]
    assert out["attn_chunk"] == (4096 if form == "chunked" else 0)
    got = out["pred_masks"]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    g = got[0, :N_VALID, :NUM_OBJ + 1].numpy()
    w = want[0, :N_VALID, :NUM_OBJ + 1]
    scale = float(np.abs(w).max()) + 1.0
    np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * scale)
    agree = (g.argmax(-1) == w.argmax(-1)).mean()
    assert agree >= 0.99, agree
    agree_f32 = (g.argmax(-1)
                 == f32[0, :N_VALID, :NUM_OBJ + 1].numpy().argmax(-1)).mean()
    assert agree_f32 >= 0.90, agree_f32


def test_bf16_weights_are_rounded_once(decoder):
    """The bf16 copy of the decoder's weights is made once per model and
    again only after a weight changed; the f32 module, its state dict and
    the f32 path are untouched; with gradients on, the bf16 decoder
    refuses to run (its weights are a copy)."""
    d = decoder
    model = _port(d, dataclasses.replace(DENSE, decoder_dtype="bfloat16"))
    keys = list(model.state_dict())
    with torch.no_grad():
        first = model._decoder_weights()
        assert model._decoder_weights() is first
        w = first.c2s_attention[0][0].multihead_attn.in_proj_weight
        src = model.c2s_attention[0][0].multihead_attn.in_proj_weight
        assert w.dtype == torch.bfloat16 and src.dtype == torch.float32
        assert torch.equal(w, src.to(torch.bfloat16))
        assert first.time_pe.dtype == torch.bfloat16
        model.decoder_norm.weight.mul_(2.0)
        second = model._decoder_weights()
        assert second is not first
        assert torch.equal(second.decoder_norm.weight,
                           model.decoder_norm.weight.to(torch.bfloat16))
    assert list(model.state_dict()) == keys
    f32 = _port(d, DENSE)
    with torch.no_grad():
        assert f32._decoder_weights() is f32
    with torch.enable_grad(), pytest.raises(NotImplementedError):
        model._decoder_weights()
