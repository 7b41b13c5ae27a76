"""The port's backward pieces against the JAX package's: ``BandedConv``
(forward kernel, dX through the same kernel with flipped channel-transposed
weights, dW through its own kernel) against ``jax.grad`` through the JAX
package's banded conv and its custom VJP (Pallas in interpret mode, as
``tests/test_banded_conv.py`` runs it), and training-mode BatchNorm
against ``batch_norm(..., training=True)``.

The plain convs' gather-only backward (``ops/sparse_conv.py::GatherConv``)
on a padded two-sample pyramid: the k3 conv, the k5 stem (dW only), a down
conv and a transposed conv against autograd through the same forward (the
scatter-add backward it replaces), a float64 ``gradcheck`` on a tiny map,
the bf16 operands' gradients against the f32 sums', and ``jax.grad``
through the JAX package's ``sparse_conv`` / ``sparse_conv_transpose``. A
training-mode Res16UNet34C forward leaves no ``IndexBackward0`` node and
counts one gather-only backward a plain conv; the sharded backbone's halo'd
rows take autograd's backward, counted as fallbacks.

Tolerances: the banded conv's gradients at max|diff| <= 1e-3 x (max + 1),
both sides rounding the same operands to bf16 and summing in f32 in other
orders; pad rows of dX exactly 0. BatchNorm at f32 (rtol 1e-5, atol 1e-6).
The gather-only backward against autograd at 1e-5 of the largest
gradient (f32, the same products summed in other orders), against JAX at
1e-5 x (max + 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.ops.banded_conv import (
    BandedConv,
    banded_conv,
    banded_conv_dw,
    banded_conv_dw_reference,
)
from agile3d_torch.models.backbone import init_res16unet
from agile3d_torch.ops import sparse_conv as sc
from agile3d_torch.ops.norm import batch_norm_train
from agile3d_torch.parallel import sp_backbone as psb
from agile3d_torch.parallel.mesh import ONE_RANK
from agile3d_torch.sparse.grid import pad_pyramid, to_device
from agile3d_torch.sparse.kernel_maps import build_pyramid
from agile3d_torch.sparse.quantize import sparse_quantize
from agile3d_tpu.ops import sparse_conv as jsc
from agile3d_tpu.ops.banded_conv import banded_conv as jax_banded_conv
from agile3d_tpu.ops.banded_conv import banded_prep
from agile3d_tpu.ops.norm import BNState, batch_norm
from tests.synthetic import make_scene
from tests.test_banded_conv import _small_padded_k3

torch.set_num_threads(1)


def _close(got, ref, name):
    err = float(np.abs(got - ref).max())
    assert err <= 1e-3 * (float(np.abs(ref).max()) + 1.0), (name, err)


@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 24)])
def test_banded_conv_grads_match_jax_custom_vjp(cin, cout):
    lvl = _small_padded_k3()
    k3 = lvl.k3
    n = k3.shape[0]
    assert n == 2048
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.standard_normal((n, cin)).astype(np.float32)
    x[~lvl.valid] = 0.0
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * 0.1
    tgt = rng.standard_normal((n, cout)).astype(np.float32)
    tgt[~lvl.valid] = 0.0
    w0_t, lo_t, exc_t, ok = banded_prep(k3)
    assert ok
    aux = (jnp.asarray(k3), jnp.asarray(lo_t), jnp.asarray(w0_t))

    def loss(x, w):
        y = jax_banded_conv(x, *aux, w, exc=exc_t)
        return jnp.sum((y - tgt) ** 2)

    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    k3t = torch.from_numpy(k3)
    launches = (banded_conv.launches, banded_conv_dw.launches)
    ((BandedConv.apply(xt, k3t, wt) - torch.from_numpy(tgt)) ** 2).sum().backward()
    # CPU tensors take the plain versions of both kernels, and only those
    assert (banded_conv.launches, banded_conv_dw.launches) == launches
    _close(xt.grad.numpy(), np.asarray(want_dx), "dx")
    _close(wt.grad.numpy(), np.asarray(want_dw), "dw")
    assert np.abs(xt.grad.numpy()[~lvl.valid]).max() == 0.0


def test_dw_plain_version_is_the_transposed_gather_product():
    """bf16-exact inputs give the exact f32 sum; absent neighbours add 0."""
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.5, 0.25]])
    k3 = torch.tensor([[1, -1], [2, 0], [-1, -1]], dtype=torch.int32)
    g = torch.tensor([[1.0], [2.0], [4.0]])
    dw = banded_conv_dw_reference(x, k3, g)
    # dw[0] = x[1] * g[0] + x[2] * g[1]; dw[1] = x[0] * g[1]
    np.testing.assert_array_equal(dw[0, :, 0].numpy(), [3.0 + 1.0, -1.0 + 0.5])
    np.testing.assert_array_equal(dw[1, :, 0].numpy(), [2.0, 4.0])
    assert banded_conv_dw(x, k3, g).equal(dw)


def test_training_batch_norm_matches_jax():
    rng = np.random.default_rng(0)
    n, c = 300, 12
    x = rng.standard_normal((n, c)).astype(np.float32) * 2 + 0.5
    valid = np.arange(n) < 217
    x[~valid] = 0.0
    scale = (0.5 + rng.random(c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32) * 0.1
    var0 = (0.5 + rng.random(c)).astype(np.float32)
    y, st = batch_norm(jnp.asarray(x), jnp.asarray(valid),
                       {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       BNState(jnp.asarray(mean0), jnp.asarray(var0)),
                       training=True, momentum=0.02)
    got, mean, var = batch_norm_train(
        torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(mean0), torch.from_numpy(var0),
        momentum=0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    assert (got.numpy()[~valid] == 0).all()
    np.testing.assert_allclose(mean.numpy(), np.asarray(st.mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(st.var), rtol=1e-5,
                               atol=1e-6)
    assert not mean.requires_grad and not var.requires_grad


# ---------------------------------------------------------------------------
# The plain convs' gather-only backward (GatherConv)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_pyr():
    """Two synthetic rooms quantized at 0.1 m, one pyramid with batch ids,
    padded to buckets (pad rows on every level), on the host."""
    rng = np.random.default_rng(21)
    grids, batch = [], []
    for b in range(2):
        coords, _, _ = make_scene(rng, n_points=2500, num_obj=3)
        vox, _, _ = sparse_quantize(coords - coords.min(0), 0.1)
        grids.append(vox)
        batch.append(np.full(len(vox), b, np.int32))
    pyr = pad_pyramid(build_pyramid(np.concatenate(grids),
                                    np.concatenate(batch)),
                      buckets=(256, 512, 1024, 2048, 4096))
    for lvl in pyr.levels:
        assert lvl.num_valid < lvl.k3.shape[0]
    return pyr


@pytest.fixture(scope="module")
def pyr(host_pyr):
    return to_device(host_pyr, "cpu")


def _rows(n, c, valid, rng, dtype=torch.float32):
    x = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    x[~valid] = 0.0
    return x.to(dtype)


def _case(pyr, kind, rng, dtype=torch.float32):
    """(forward f(x, w), x, w, x's valid rows, the plain forward) of one
    conv of the pyramid: the gather-only path and the plain code under
    autograd (``_gather_conv`` / ``_parent_conv``, as the parent ran)."""
    lv = pyr.levels
    if kind == "k3":
        l = lv[1]
        x, w = _rows(l.k3.shape[0], 6, l.valid, rng), rng.standard_normal(
            (27, 6, 5))
        return (lambda x, w: sc.sparse_conv(x, l.k3, w, stencil=True),
                lambda x, w: sc._gather_conv(x, l.k3, w), x, w, l.valid)
    if kind == "stem":
        l = lv[0]
        x, w = _rows(l.k5.shape[0], 3, l.valid, rng), rng.standard_normal(
            (125, 3, 4))
        return (lambda x, w: sc.sparse_conv(x, l.k5, w, stencil=True),
                lambda x, w: sc._gather_conv(x, l.k5, w), x, w, l.valid)
    if kind == "down":
        l = lv[0]
        x, w = _rows(l.k3.shape[0], 5, l.valid, rng), rng.standard_normal(
            (8, 5, 7))
        return (lambda x, w: sc.sparse_conv(
                    x, l.down, w, up=(l.up_parent, l.up_offset)),
                lambda x, w: sc._gather_conv(x, l.down, w), x, w, l.valid)
    l, c = lv[1], lv[2]
    x, w = _rows(c.k3.shape[0], 7, c.valid, rng), rng.standard_normal(
        (8, 7, 4))
    return (lambda x, w: sc.sparse_conv_transpose(
                x, l.up_parent, l.up_offset, w, down=l.down),
            lambda x, w: sc._parent_conv(x, l.up_parent, l.up_offset, w),
            x, w, c.valid)


def _grads(f, x, w, gy):
    """f(x, w)'s output and its (dX, dW) for the upstream gradient gy; dX
    None where x needs none (the stem's features)."""
    out = f(x, w)
    ins = (x, w) if x.requires_grad else (w,)
    got = torch.autograd.grad(out, ins, gy)
    return out, (got if x.requires_grad else (None, got[0]))


@pytest.mark.parametrize("kind", ["k3", "k5", "down"])
def test_pyramid_maps_are_the_inverses_gather_conv_is_named(host_pyr, kind):
    """The identities ``GatherConv``'s callers vouch for, on every level of
    a padded pyramid: a stencil map is its own inverse (nbr[m, k] = n
    exactly when nbr[n, K-1-k] = m), and a down map's inverse is the
    level's up map (down[c, k] = n exactly when up_parent[n] = c and
    up_offset[n] = k; every row with a parent is read once)."""
    checked = 0
    for lvl in host_pyr.levels:
        nbr = lvl.k5 if kind == "k5" else lvl.k3 if kind == "k3" else lvl.down
        if nbr is None:
            continue
        m, k = np.nonzero(nbr >= 0)
        n = nbr[m, k]
        if kind == "down":
            assert np.array_equal(lvl.up_parent[n], m)
            assert np.array_equal(lvl.up_offset[n], k)
            assert len(np.unique(n)) == len(n)
            assert len(n) == int((lvl.up_parent >= 0).sum())
        else:
            assert nbr.shape[0] == lvl.k3.shape[0] and nbr.shape[1] % 2
            assert np.array_equal(nbr[n, nbr.shape[1] - 1 - k], m)
            assert len(n) == int((nbr >= 0).sum())
        checked += 1
    assert checked == (1 if kind == "k5" else len(host_pyr.levels) - (
        kind == "down"))


@pytest.mark.parametrize("kind", ["k3", "stem", "down", "transposed"])
def test_gather_conv_grads_match_autograd(pyr, kind):
    """dX and dW of the gather-only backward equal autograd's through the
    plain forward, which is the same forward bit for bit; dX is exactly 0
    on pad rows; one backward counted, no fallback."""
    rng = np.random.default_rng(len(kind))
    f, plain, x, w, valid = _case(pyr, kind, rng)
    x.requires_grad_(kind != "stem")
    w = torch.from_numpy(w.astype(np.float32) * 0.3).requires_grad_()
    gy = torch.from_numpy(rng.standard_normal(
        tuple(plain(x, w).shape)).astype(np.float32))
    counts = (sc.GatherConv.backwards, sc.GatherConv.fallbacks)
    out, got = _grads(f, x, w, gy)
    assert (sc.GatherConv.backwards - counts[0],
            sc.GatherConv.fallbacks - counts[1]) == (1, 0)
    want_out, want = _grads(plain, x, w, gy)
    assert torch.equal(out, want_out)
    for g, r, name in zip(got, want, ("dx", "dw")):
        if r is None:
            assert g is None and kind == "stem"
            continue
        err = float((g - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), (name, err)
    if got[0] is not None:
        assert float(got[0][~valid].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["stencil", "down", "transposed"])
def test_gather_conv_gradcheck_float64(kind):
    """float64 gradcheck on a tiny map: a 1-D k3 stencil on 5 rows with
    holes (kernel_offsets' symmetric order), a down conv of 2 coarse rows
    with its inverse, and the transposed conv of that map."""
    stencil = torch.tensor([[-1, 0, 1], [0, 1, -1], [-1, 2, 3], [2, 3, 4],
                            [3, 4, -1], [-1, -1, -1]], dtype=torch.int32)
    down = torch.tensor([[0, -1, 2], [3, 1, -1], [-1, -1, -1]],
                        dtype=torch.int32)
    parent = torch.tensor([0, 1, 0, 1, -1], dtype=torch.int32)
    offset = torch.tensor([0, 1, 2, 0, 0], dtype=torch.int32)
    g = torch.Generator().manual_seed(7)
    if kind == "stencil":
        x = torch.randn(6, 3, generator=g, dtype=torch.float64)
        x[5] = 0.0
        w = torch.randn(3, 3, 2, generator=g, dtype=torch.float64)
        f = lambda x, w: sc.sparse_conv(x, stencil, w, stencil=True)
    elif kind == "down":
        x = torch.randn(5, 3, generator=g, dtype=torch.float64)
        x[4] = 0.0
        w = torch.randn(3, 3, 2, generator=g, dtype=torch.float64)
        f = lambda x, w: sc.sparse_conv(x, down, w, up=(parent, offset))
    else:
        x = torch.randn(3, 2, generator=g, dtype=torch.float64)
        x[2] = 0.0
        w = torch.randn(3, 2, 4, generator=g, dtype=torch.float64)
        f = lambda x, w: sc.sparse_conv_transpose(x, parent, offset, w,
                                                  down=down)
    n0 = sc.GatherConv.backwards
    assert torch.autograd.gradcheck(f, (x.requires_grad_(),
                                        w.requires_grad_()))
    assert sc.GatherConv.backwards > n0


@pytest.mark.parametrize("kind", ["k3", "down", "transposed"])
def test_gather_conv_bf16_grads_are_f32_sums_cast_once(pyr, kind):
    """bf16 operands: dX and dW are the f32 path's gradients (for the same
    values and the upstream gradient in f32) cast to bf16, bit for bit."""
    rng = np.random.default_rng(3 + len(kind))
    f, _, x, w, _ = _case(pyr, kind, rng)
    xb = x.to(torch.bfloat16).requires_grad_()
    wb = torch.from_numpy(w.astype(np.float32) * 0.3).to(
        torch.bfloat16).requires_grad_()
    outb = f(xb, wb)
    assert outb.dtype == torch.bfloat16
    gy = torch.from_numpy(rng.standard_normal(
        tuple(outb.shape)).astype(np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(outb, (xb, wb), gy)
    x32 = xb.detach().float().requires_grad_()
    w32 = wb.detach().float().requires_grad_()
    want = torch.autograd.grad(f(x32, w32), (x32, w32), gy.float())
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["k3", "down", "transposed"])
def test_gather_conv_grads_match_jax(pyr, kind):
    """jax.grad through the JAX package's sparse_conv (scanned k3, unrolled
    down conv) and sparse_conv_transpose on the same maps and weights."""
    rng = np.random.default_rng(11 + len(kind))
    f, _, x, w, _ = _case(pyr, kind, rng)
    w = (w * 0.3).astype(np.float32)
    lv = pyr.levels
    if kind == "k3":
        jf = lambda x, w: jsc.sparse_conv(x, jnp.asarray(lv[1].k3.numpy()), w)
    elif kind == "down":
        jf = lambda x, w: jsc.sparse_conv(x, jnp.asarray(lv[0].down.numpy()),
                                          w)
    else:
        jf = lambda x, w: jsc.sparse_conv_transpose(
            x, jnp.asarray(lv[1].up_parent.numpy()),
            jnp.asarray(lv[1].up_offset.numpy()), w)
    xt = x.clone().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = f(xt, wt)
    tgt = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    want_dx, want_dw = jax.grad(
        lambda x, w: jnp.sum((jf(x, w) - tgt) ** 2), argnums=(0, 1))(
        jnp.asarray(x.numpy()), jnp.asarray(w))
    for got, want, name in ((xt.grad, want_dx, "dx"), (wt.grad, want_dw, "dw")):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * (float(np.abs(want).max()) + 1.0), (name, err)


def _backbone_nodes(outs) -> dict:
    """Autograd nodes of the graph behind ``outs``, counted by type."""
    seen, stack, names = set(), [o.grad_fn for o in outs], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names[type(fn).__name__] = names.get(type(fn).__name__, 0) + 1
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _features(pyr, seed):
    lv0 = pyr.levels[0]
    x = torch.rand(lv0.k3.shape[0], 3,
                   generator=torch.Generator().manual_seed(seed))
    x[~lv0.valid] = 0.0
    return x


def _fmap_loss(fmaps, seed):
    g = torch.Generator().manual_seed(seed)
    return sum((f * torch.randn(f.shape, generator=g)).sum() for f in fmaps)


def test_backbone_graph_has_no_index_backward(pyr):
    """A training-mode Res16UNet34C forward on the CPU (every conv plain)
    leaves no IndexBackward0 node: 55 gather-only backwards (46 k3 convs,
    the stem, 4 down and 4 transposed convs) and no fallback."""
    net = init_res16unet(device="cpu").train()
    counts = (sc.GatherConv.backwards, sc.GatherConv.fallbacks)
    fmaps = net(pyr, _features(pyr, 0), bn_stats={})
    nodes = _backbone_nodes(fmaps)
    assert "IndexBackward0" not in nodes
    assert nodes["GatherConvBackward"] == 55
    _fmap_loss(fmaps, 1).backward()
    assert (sc.GatherConv.backwards - counts[0],
            sc.GatherConv.fallbacks - counts[1]) == (55, 0)
    assert all(p.grad is not None for p in net.parameters()
               if p.requires_grad)


def test_sharded_backbone_training_falls_back(host_pyr, pyr):
    """The sharded backbone's rows (a rank's block followed by its halo,
    here one rank's: the halo ladder's 128 rows) are longer than the maps,
    so every plain conv under gradients takes autograd's backward, counted
    as a fallback; its weight gradients equal the gather-only ones of the
    one-process backbone."""
    net = init_res16unet(device="cpu").train()
    params = [p for p in net.parameters() if p.requires_grad]
    feats = _features(pyr, 2)
    want = torch.autograd.grad(_fmap_loss(net(pyr, feats, bn_stats={}), 3),
                               params)
    lv = psb.local_pyramid(psb.partition_pyramid(host_pyr, 1), ONE_RANK,
                           "cpu")
    counts = (sc.GatherConv.backwards, sc.GatherConv.fallbacks)
    fmaps = net(psb.SPPyramid(lv), feats, bn_stats={},
                rows=psb.RowShards(ONE_RANK))
    got = torch.autograd.grad(_fmap_loss(fmaps, 3), params)
    assert (sc.GatherConv.backwards - counts[0],
            sc.GatherConv.fallbacks - counts[1]) == (0, 55)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max())
                                                     + 1e-3)
