"""The port's bf16 backbone (``ModelConfig.backbone_dtype="bfloat16"``)
against the JAX package's ``backbone_forward(..., compute_dtype=bfloat16)``
at a reduced width on the CPU, with the same weights and inputs.

What is held:
  * the FPN maps' dtypes equal JAX's: float32 in eval (a residual block's
    BatchNorm against the f32 running statistics promotes), bfloat16 in
    training (batch statistics in bf16);
  * the port's bf16 maps differ from JAX's bf16 maps by at most twice
    JAX's own bf16-vs-f32 difference on the same scene (relative Frobenius
    norm, per FPN level): the two frameworks round bf16 at other places
    (XLA on the CPU may keep a fused chain in f32), so the bound is set by
    bf16 itself. Measured on this scene with the port's one rounding of
    an f32 sum a conv: eval 0.05-0.54x, training 1.09-1.21x (a bf16 sum
    per offset, 1.3-1.5x here and 1.5-1.7x at Res16UNet34C's depth, would
    also meet the bound; PERF.md says why the port does not use it);
  * the running statistics after a bf16 training forward are f32 and equal
    JAX's within 4 bf16 ulps (2^-7) of the update's batch share, momentum x
    the batch statistic, at its largest in the layer (measured: 2.3 ulps;
    the statistics are bf16 on both sides and their inputs differ as the
    maps do);
  * the kernels' plain versions under bf16 operands: a bf16 operand gives
    the f32 result on its values, cast to x's dtype, and ``BandedConv``'s
    gradients come back in x's and w's dtypes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.models.backbone import commit_bn_stats
from agile3d_torch.ops.banded_conv import BandedConv, banded_conv, banded_conv_dw
from agile3d_torch.ops.banded_stem import banded_stem_conv
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.ckpt import export_reference_state_dict
from agile3d_tpu.data.datasets import collate_scenes
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.models.backbone import backbone_forward
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_model import SMALL, port_model, randomized_weights, small_scene

torch.set_num_threads(1)

BF16_SMALL = dataclasses.replace(SMALL, backbone_dtype="bfloat16")
MAP_RATIO = 2.0      # port-vs-JAX bf16 over JAX's own bf16-vs-f32
BN_ULPS = 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    sd, params, buffers, bn_state = randomized_weights(SMALL, 3, rng)
    jsample, psample = small_scene(9)
    jbatch = collate_scenes([jsample])
    pbatch = port_collate([psample])
    jax_maps = {}
    for training in (False, True):
        for cd in (None, jnp.bfloat16):
            fmaps, new_bn = jax.jit(lambda p, st, pyr, x: backbone_forward(
                p, st, pyr, x, training=training, cfg=SMALL.backbone,
                compute_dtype=cd))(params["backbone"], bn_state,
                                   jbatch.pyramid, jnp.asarray(jbatch.feats))
            jax_maps[training, cd] = (fmaps, new_bn)
    return dict(sd=sd, params=params, buffers=buffers, bn_state=bn_state,
                jbatch=jbatch, pbatch=pbatch, jax=jax_maps)


def _port(s, training, dtype=torch.bfloat16, model=None):
    model = model or port_model(BF16_SMALL, s["sd"])
    b = s["pbatch"]
    bn_stats = {} if training else None
    with torch.no_grad():
        maps = model.backbone(to_device(b.pyramid, "cpu"),
                              torch.from_numpy(b.feats), bn_stats,
                              compute_dtype=dtype)
    return model, maps, bn_stats


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_fpn_dtypes_match_jax(setup, training):
    jmaps, _ = setup["jax"][training, jnp.bfloat16]
    _, maps, _ = _port(setup, training)
    want = ["float32" if not training else "bfloat16"] * 5
    assert [str(np.dtype(m.dtype)) for m in jmaps] == want
    assert [str(m.dtype).replace("torch.", "") for m in maps] == want


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_bf16_maps_within_twice_jax_own_difference(setup, training):
    jbf, _ = setup["jax"][training, jnp.bfloat16]
    jf32, _ = setup["jax"][training, None]
    _, maps, _ = _port(setup, training)
    b = setup["jbatch"]
    for lvl, got, want, ref in zip((4, 3, 2, 1, 0), maps, jbf, jf32):
        n = b.pyramid.levels[lvl].num_valid
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        ref = np.asarray(ref)
        own = _rel(want[:n], ref[:n])
        assert 0.0 < own < 0.05, (lvl, own)
        assert _rel(got[:n], want[:n]) <= MAP_RATIO * own, (lvl, own)
        assert np.abs(got[n:]).max(initial=0.0) == 0.0, f"pad rows, level {lvl}"


def test_bn_running_stats_match_jax_in_training(setup):
    s = setup
    _, new_bn = s["jax"][True, jnp.bfloat16]
    want = export_torch_state_dict(s["params"], s["buffers"], SMALL, new_bn)
    model, _, bn_stats = _port(s, True)
    assert all(m.dtype == torch.float32 and v.dtype == torch.float32
               for m, v in bn_stats.values())
    commit_bn_stats(bn_stats)
    got = export_reference_state_dict(model)
    keys = [k for k in want if k.startswith("backbone.") and "running" in k]
    assert len(keys) == 2 * len(bn_stats)
    for k in keys:
        old = np.asarray(s["sd"][k], np.float64)
        new = np.asarray(want[k], np.float64)
        # the batch statistic's share of the update, momentum x statistic
        share = np.abs(new - (1 - SMALL.backbone.bn_momentum) * old).max()
        err = np.abs(got[k] - new).max() / share
        assert err <= BN_ULPS * 2.0 ** -7, (k, err)


def test_scene_features_follow_jax(setup):
    """forward_backbone with backbone_dtype bf16: lin_squeeze reads the
    stride-1 map in f32, so the scene features are f32 and within the
    map bound of JAX's."""
    s = setup
    b = s["jbatch"]
    args = (b.pyramid, jnp.asarray(b.feats), jnp.asarray(b.raw),
            jnp.asarray(b.sample_idx))
    run = lambda cfg: jax.jit(lambda *a: jmodel.forward_backbone(
        *a, cfg=cfg))(s["params"], s["buffers"], s["bn_state"], *args)[0]
    want, ref = run(BF16_SMALL), run(SMALL)
    model = port_model(BF16_SMALL, s["sd"])
    pb = s["pbatch"]
    with torch.no_grad():
        got = model.forward_backbone(
            to_device(pb.pyramid, "cpu"), torch.from_numpy(pb.feats),
            torch.from_numpy(pb.raw), torch.from_numpy(pb.sample_idx))
    assert want.mask_feat.dtype == jnp.float32
    assert got.mask_feat.dtype == torch.float32
    n = int(got.vox_valid.sum())
    own = _rel(np.asarray(want.mask_feat)[0, :n], np.asarray(ref.mask_feat)[0, :n])
    assert _rel(got.mask_feat[0, :n].numpy(),
                np.asarray(want.mask_feat)[0, :n]) <= MAP_RATIO * own
    # the positional encoding does not see the backbone: f32 on both sides
    np.testing.assert_allclose(got.pos_pcd.numpy(), np.asarray(want.pos_pcd),
                               rtol=0, atol=1e-6)


def test_eval_weight_copy_is_made_once_and_rebuilt_on_change(setup):
    model = port_model(BF16_SMALL, setup["sd"])
    _, first, _ = _port(setup, False, model=model)
    cached = model.backbone.__dict__["_cast_weights"]
    _, again, _ = _port(setup, False, model=model)
    assert model.backbone.__dict__["_cast_weights"] is cached
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(t.dtype == torch.bfloat16 for t in cached[1].values())
    assert "_cast_weights" not in "".join(model.state_dict())
    with torch.no_grad():
        model.backbone.conv0p1s1.kernel.mul_(2.0)
    _, changed, _ = _port(setup, False, model=model)
    assert model.backbone.__dict__["_cast_weights"] is not cached
    assert not torch.equal(changed[-1], first[-1])


def test_training_gradients_reach_the_f32_weights(setup):
    model = port_model(BF16_SMALL, setup["sd"])
    b = setup["pbatch"]
    maps = model.backbone(to_device(b.pyramid, "cpu"),
                          torch.from_numpy(b.feats), {},
                          compute_dtype=torch.bfloat16)
    assert maps[-1].dtype == torch.bfloat16
    sum(m.float().square().sum() for m in maps).backward()
    for name, p in model.backbone.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


def _operands(seed, n=300, cin=40, cout=24, k=27):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, generator=g)
    nbr = torch.randint(-n // 2, n, (n, k), generator=g,
                        dtype=torch.int32).clamp(min=-1)
    w = torch.randn(k, cin, cout, generator=g) * (k * cin) ** -0.5
    return x, nbr, w


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_plain_kernels_take_bf16_operands(x_dtype, w_dtype):
    """A bf16 operand gives the f32 result on its values, in x's dtype."""
    x, nbr, w = _operands(1)
    xd, wd = x.to(x_dtype), w.to(w_dtype)
    y = banded_conv(xd, nbr, wd)
    assert y.dtype == x_dtype
    assert torch.equal(y, banded_conv(xd.float(), nbr, wd.float()).to(x_dtype))
    g = torch.randn(x.shape[0], w.shape[2]).to(x_dtype)
    dw = banded_conv_dw(xd, nbr, g)
    assert dw.dtype == torch.float32
    assert torch.equal(dw, banded_conv_dw(xd.float(), nbr, g.float()))
    x5, k5, w5 = _operands(2, cin=3, cout=32, k=125)
    xs, ws = x5.to(x_dtype), w5.to(w_dtype)
    ys = banded_stem_conv(xs, k5, ws)
    assert ys.dtype == x_dtype
    assert torch.equal(ys, banded_stem_conv(xs.float(), k5,
                                            ws.float()).to(x_dtype))


def test_banded_conv_gradients_in_the_operands_dtypes():
    x, nbr, w = _operands(3)
    xb = x.to(torch.bfloat16).requires_grad_()
    wf = w.clone().requires_grad_()
    wb = wf.to(torch.bfloat16)
    y = BandedConv.apply(xb, nbr, wb)
    assert y.dtype == torch.bfloat16
    g = torch.randn(y.shape).to(torch.bfloat16)
    y.backward(g)
    assert xb.grad.dtype == torch.bfloat16 and wf.grad.dtype == torch.float32
    want_dx = banded_conv(g.float(), nbr, wb.float(), transposed=True)
    assert torch.equal(xb.grad, want_dx.to(torch.bfloat16))
    want_dw = banded_conv_dw(xb.detach().float(), nbr, g.float())
    assert torch.equal(wf.grad, want_dw.to(torch.bfloat16).float())


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_kernel_route_keeps_the_dtypes(setup, training, monkeypatch):
    """The backbone with the kernels' route forced on at this scene's size
    (their plain versions on the CPU) gives the FPN dtypes of the plain
    route."""
    import agile3d_torch.models.backbone as backbone

    monkeypatch.setattr(backbone, "BANDED_MIN_ROWS", 0)
    monkeypatch.setattr(backbone, "BANDED_MIN_CIN", 0)
    model = port_model(BF16_SMALL, setup["sd"])
    model.backbone.cfg = dataclasses.replace(model.backbone.cfg,
                                             banded_conv=True)
    _, maps, _ = _port(setup, training, model=model)
    _, plain, _ = _port(setup, training)
    assert [m.dtype for m in maps] == [m.dtype for m in plain]
    for got, want in zip(maps, plain):
        assert _rel(got.float().numpy(), want.float().numpy()) < 0.05
