"""The port's decoder dropout against the JAX package's.

The two frameworks draw different random bits from a seed, so the masks
are JAX's: the port's ``ops.attention.dropout`` is replaced (in these tests
only) by one that applies, call by call, the keep masks that JAX's
``dropout`` draws from the same keys (``forward_mask`` splits its key into
four per round, c2s / c2c / ffn / s2c, and each layer splits its own into
the attention probabilities' and the residual's, the FFN's into its inner
activation's and the residual's). With them, the layers and
``forward_mask`` equal JAX's at the decoder tests' tolerance (atol 1e-4,
``tests/test_torch_model.py``). The port's own draws are held by their
share and scale, by determinism from a seed, by the rematerialised
backward drawing the forward's masks again, and by the training loop
drawing the seed where the JAX package draws its key."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.config import TrainConfig as PortTrainConfig
from agile3d_torch.engine import train as ptrain
from agile3d_torch.models import agile3d as pmodel
from agile3d_torch.models.agile3d import Agile3D, ClickState, SceneFeatures
from agile3d_torch.ops import attention as pattn
from agile3d_torch.utils.ckpt import load_reference_state_dict
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.ops import attention as jattn
from tests.test_torch_model import SMALL, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

RATE = 0.1
DROP = dataclasses.replace(SMALL, dropout=RATE)
ATOL = 1e-4
N_ROWS, N_VALID, NUM_OBJ, MC, COUNT = 512, 400, 3, 32, 9


def _scene(seed, n_rows=N_ROWS, n_valid=N_VALID):
    rng = np.random.default_rng(seed)
    c = SMALL.hidden_dim
    valid = np.zeros((1, n_rows), bool)
    valid[0, :n_valid] = True
    mask_feat = rng.standard_normal((1, n_rows, c)).astype(np.float32)
    pos_pcd = rng.uniform(-1, 1, (1, n_rows, c)).astype(np.float32)
    raw = rng.uniform(0, 4, (1, n_rows, 3)).astype(np.float32)
    for a in (mask_feat, pos_pcd, raw):
        a[~valid] = 0.0
    cmin, cmax = raw[0, :n_valid].min(0)[None], raw[0, :n_valid].max(0)[None]
    labels = rng.integers(0, NUM_OBJ + 1, n_valid)
    vox = np.full((1, MC), -1, np.int32)
    obj = np.zeros((1, MC), np.int32)
    rows = rng.choice(n_valid, COUNT, replace=False)
    vox[0, :COUNT] = rows
    obj[0, :COUNT] = labels[rows]
    tim = np.arange(MC, dtype=np.int32)[None]
    return ((mask_feat, pos_pcd, valid, raw, cmin, cmax), (vox, obj, tim),
            np.array([NUM_OBJ], np.int32))


@pytest.fixture(scope="module")
def decoder():
    sd, params, buffers, _ = randomized_weights(DROP, 7,
                                                np.random.default_rng(7))
    return dict(sd=sd, params=params,
                buffers=jax.tree_util.tree_map(jnp.asarray, buffers),
                arrays=_scene(8))


def _port(d, cfg=DROP, **kw):
    model = Agile3D(dataclasses.replace(port_model_config(cfg), **kw))
    load_reference_state_dict(model, d["sd"])
    return model.eval()


def _port_inputs(arrays):
    scene, clicks, num_obj = arrays
    return (SceneFeatures(*map(torch.from_numpy, scene)),
            ClickState(*map(torch.from_numpy, clicks)),
            torch.from_numpy(num_obj))


def _keep(key, shape):
    return np.asarray(jax.random.bernoulli(key, 1.0 - RATE, shape))


def _round_masks(rng4, b, q, n, c, heads, ff):
    """The keep masks JAX's round draws from its four keys, in the order of
    its dropout calls."""
    masks = []
    for j, (probs, res) in enumerate((((b, heads, q, n), (b, q, c)),
                                      ((b, heads, q, q), (b, q, c)),
                                      ((b, q, ff), (b, q, c)),
                                      ((b, heads, n, q), (b, n, c)))):
        first, second = jax.random.split(rng4[j])
        masks += [_keep(first, probs), _keep(second, res)]
    return masks


def _jax_masks(train_rng, cfg, b, q, n):
    n_rounds = cfg.num_decoders * len(cfg.hlevels)
    rngs = jax.random.split(train_rng, n_rounds * 4).reshape(n_rounds, 4, -1)
    return [m for r in range(n_rounds)
            for m in _round_masks(rngs[r], b, q, n, cfg.hidden_dim,
                                  cfg.num_heads, cfg.dim_feedforward)]


@pytest.fixture
def jax_masks(monkeypatch):
    """The port's dropout applying the queued masks in call order."""
    queue = []

    def applied(x, rate, generator):
        if rate == 0.0 or generator is None:
            return x
        keep = torch.from_numpy(np.array(queue.pop(0)))
        assert tuple(keep.shape) == tuple(x.shape)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(pattn, "dropout", applied)
    return queue


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layer", ["c2s", "c2c", "ffn", "s2c"])
def test_layers_match_jax_with_jax_masks(decoder, jax_masks, layer):
    d = decoder
    model = _port(d)
    dp = d["params"]["decoders"][0]
    rng = np.random.default_rng(3)
    b, q, n, c, h = 2, 12, 40, DROP.hidden_dim, DROP.num_heads
    tgt_len = n if layer == "s2c" else q
    mem_len = q if layer == "s2c" else n
    tgt, mem = _rand(rng, b, tgt_len, c), _rand(rng, b, mem_len, c)
    pos, qpos = _rand(rng, b, mem_len, c), _rand(rng, b, tgt_len, c)
    bias = np.where(rng.random((b, tgt_len, mem_len)) < 0.2, -1e9,
                    0.0).astype(np.float32)
    key = jax.random.PRNGKey(11)
    first, second = jax.random.split(key)
    if layer in ("c2s", "s2c"):
        want = jattn.cross_attention_layer(
            dp[layer], jnp.asarray(tgt), jnp.asarray(mem), h,
            pos=jnp.asarray(pos), query_pos=jnp.asarray(qpos),
            attn_bias=jnp.asarray(bias), dropout_rate=RATE, rng=key)
        jax_masks += [_keep(first, (b, h, tgt_len, mem_len)),
                      _keep(second, (b, tgt_len, c))]
        got = getattr(model, f"{layer}_attention")[0][0](
            torch.from_numpy(tgt), torch.from_numpy(mem),
            pos=torch.from_numpy(pos), query_pos=torch.from_numpy(qpos),
            attn_bias=torch.from_numpy(bias), generator=_gen())
    elif layer == "c2c":
        qbias = bias[:, :, :q]
        want = jattn.self_attention_layer(
            dp["c2c"], jnp.asarray(tgt), h, query_pos=jnp.asarray(qpos),
            attn_bias=jnp.asarray(qbias), dropout_rate=RATE, rng=key)
        jax_masks += [_keep(first, (b, h, q, q)), _keep(second, (b, q, c))]
        got = model.c2c_attention[0][0](
            torch.from_numpy(tgt), query_pos=torch.from_numpy(qpos),
            attn_bias=torch.from_numpy(qbias), generator=_gen())
    else:
        want = jattn.ffn_layer(dp["ffn"], jnp.asarray(tgt),
                               dropout_rate=RATE, rng=key)
        jax_masks += [_keep(first, (b, q, DROP.dim_feedforward)),
                      _keep(second, (b, q, c))]
        got = model.ffn_attention[0][0](torch.from_numpy(tgt),
                                        generator=_gen())
    assert not jax_masks, "every mask applied"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    # and the masks mattered
    no_drop = jattn.ffn_layer(dp["ffn"], jnp.asarray(tgt)) if layer == "ffn" \
        else None
    if no_drop is not None:
        assert np.abs(np.asarray(no_drop) - np.asarray(want)).max() > 1e-2


def test_forward_mask_matches_jax_with_jax_masks(decoder, jax_masks):
    d = decoder
    scene, clicks, num_obj = d["arrays"]
    train_rng = jax.random.PRNGKey(5)
    want = jmodel.forward_mask(
        d["params"], d["buffers"], jmodel.SceneFeatures(*map(jnp.asarray,
                                                             scene)),
        jmodel.ClickState(*map(jnp.asarray, clicks)), jnp.asarray(num_obj),
        cfg=DROP, train_rng=train_rng)
    jax_masks += _jax_masks(train_rng, DROP, 1, DROP.num_bg_queries + MC,
                            N_ROWS)
    with torch.no_grad():
        got = _port(d).forward_mask(*_port_inputs(d["arrays"]),
                                    train_gen=_gen())
    assert not jax_masks, "every mask applied"
    assert got["attn_chunk"] == 0
    for key in ("pred_masks", "aux_masks"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    plain = jmodel.forward_mask(
        d["params"], d["buffers"], jmodel.SceneFeatures(*map(jnp.asarray,
                                                             scene)),
        jmodel.ClickState(*map(jnp.asarray, clicks)), jnp.asarray(num_obj),
        cfg=DROP)
    assert np.abs(np.asarray(plain["pred_masks"])
                  - np.asarray(want["pred_masks"])).max() > 1e-2


def test_rate_zero_and_eval_are_the_identity(decoder):
    x = torch.randn(4, 5, generator=_gen(1))
    assert pattn.dropout(x, 0.0, _gen()) is x
    assert pattn.dropout(x, RATE, None) is x
    d = decoder
    inputs = _port_inputs(d["arrays"])
    with torch.no_grad():
        ref = _port(d, dropout=0.0).forward_mask(*inputs)
        zero = _port(d, dropout=0.0).forward_mask(*inputs, train_gen=_gen())
        evaluated = _port(d).forward_mask(*inputs)
    for key in ("pred_masks", "aux_masks"):
        assert torch.equal(zero[key], ref[key])
        assert torch.equal(evaluated[key], ref[key])


def test_keep_share_and_scale():
    x = torch.ones(1_000_000)
    y = pattn.dropout(x, RATE, _gen(3))
    kept = y != 0
    share = float(kept.float().mean())
    # binomial: sd sqrt(0.9 * 0.1 / 1e6) = 3e-4
    assert abs(share - (1 - RATE)) < 5 * 3e-4, share
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - RATE)))
    assert torch.equal(pattn.dropout(x, RATE, _gen(3)), y)
    assert not torch.equal(pattn.dropout(x, RATE, _gen(4)), y)


def test_dropout_forces_dense_attention(decoder):
    """At 24,576 rows the dense threshold 0 picks 4,096-row chunks; a
    training generator with dropout > 0 runs dense instead, as JAX does."""
    d = decoder
    inputs = _port_inputs(_scene(9, 24576, 15000))
    with torch.no_grad():
        chunked = _port(d, attn_dense_threshold=0).forward_mask(*inputs)
        trained = _port(d, attn_dense_threshold=0).forward_mask(
            *inputs, train_gen=_gen())
        no_rate = _port(d, dropout=0.0, attn_dense_threshold=0).forward_mask(
            *inputs, train_gen=_gen())
    assert chunked["attn_chunk"] == no_rate["attn_chunk"] == 4096
    assert trained["attn_chunk"] == 0


def _grads(d, remat: bool, monkeypatch, seed=0):
    if not remat:
        monkeypatch.setattr(pmodel, "checkpoint",
                            lambda fn, *args, **kw: fn(*args))
    model = _port(d)
    scene, clicks, num_obj = _port_inputs(d["arrays"])
    out = model.forward_mask(scene, clicks, num_obj, train_gen=_gen(seed))
    out["all_masks"].square().mean().backward()
    monkeypatch.undo()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def test_backward_redraws_the_forward_masks(decoder, monkeypatch):
    """Each round is recomputed in the backward (torch.utils.checkpoint):
    its generators, made again from the round's seeds, give the forward's
    masks, so the gradients equal those of a pass that keeps every
    activation; another seed gives other gradients."""
    kept = _grads(decoder, False, monkeypatch)
    remat = _grads(decoder, True, monkeypatch)
    assert kept.keys() == remat.keys() and len(kept) > 0
    for name, g in kept.items():
        torch.testing.assert_close(remat[name], g, rtol=1e-5, atol=1e-7,
                                   msg=name)
    other = _grads(decoder, True, monkeypatch, seed=1)
    assert any(not torch.allclose(other[n], g) for n, g in kept.items())


def test_train_step_is_deterministic_from_a_seed(decoder):
    """Two supervised steps from one generator seed give equal losses and
    gradients; the rate-0 step differs."""
    from tests.test_torch_train import _step_inputs
    from agile3d_tpu.config import Config
    from agile3d_torch.sparse.grid import to_device

    jb, pb, labels, num_obj, (vox, obj, tm) = _step_inputs(Config(model=DROP))
    batch = (to_device(pb.pyramid, "cpu"), torch.from_numpy(pb.feats),
             torch.from_numpy(pb.raw), torch.from_numpy(pb.sample_idx))
    args = (ClickState(*(torch.from_numpy(a) for a in (vox, obj, tm))),
            torch.from_numpy(labels), torch.from_numpy(num_obj))

    def step(seed, **kw):
        model = _port(decoder, **kw)
        cfg = PortConfig(model=model.cfg)
        opt, _ = ptrain.make_optimizer(model, cfg, 1)
        out = ptrain.make_train_step(cfg, model, opt)(
            batch, *args, None if seed is None else _gen(seed))
        return float(out["loss"]), out["attn_chunk"], {
            n: p.detach().clone() for n, p in model.named_parameters()}

    a, b, zero = step(3), step(3), step(None)
    assert a[0] == b[0] and np.isfinite(a[0]) and a[1] == 0
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])
    assert zero[0] != a[0]


def test_epoch_draws_the_seed_where_jax_draws_its_key(monkeypatch, tmp_path):
    """``train_one_epoch`` seeds each step's dropout generator from
    ``np_rng`` after the batch seeds and the rollout, once per step, only
    when dropout > 0: the draws the JAX package's epoch makes."""
    from agile3d_torch.data.datasets import InterMultiObjDataset
    from agile3d_torch.data.synthetic import write_benchmark
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.models.agile3d import init_agile3d

    scans, lst = write_benchmark(str(tmp_path), num_scenes=3, num_obj=2,
                                 seed=4, n_points=1000)
    for rate in (RATE, 0.0):
        mcfg = dataclasses.replace(port_model_config(SMALL), dropout=rate,
                                   max_clicks=256)
        cfg = PortConfig(model=mcfg, train=PortTrainConfig(batch_size=2))
        engine = InteractiveEngine(cfg, init_agile3d(mcfg, device="cpu"),
                                   "cpu")
        seen = []

        def train_step(batch, clicks, labels, num_obj, gen=None):
            seen.append(None if gen is None else gen.initial_seed())
            return {"loss": torch.tensor(1.0), "gnorm": torch.tensor(0.0),
                    "miou": torch.tensor(0.0), "losses": {}}

        np_rng = np.random.default_rng(21)
        ptrain.train_one_epoch(engine, train_step, InterMultiObjDataset(
            scans, lst, 0.05), cfg, 0, np_rng=np_rng,
            py_rng=random.Random(2), log=lambda m: None)
        want_rng = np.random.default_rng(21)
        want_rng.permutation(3)
        want_rng.integers(2 ** 31, size=2)
        want = ([int(want_rng.integers(2 ** 31)) for _ in range(2)]
                if rate > 0 else [None, None])
        assert seen == want
        assert np_rng.integers(2 ** 31) == want_rng.integers(2 ** 31)
