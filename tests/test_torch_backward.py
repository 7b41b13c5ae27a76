"""The port's backward pieces against the JAX package's: ``BandedConv``
(forward kernel, dX through the same kernel with flipped channel-transposed
weights, dW through its own kernel) against ``jax.grad`` through the JAX
package's banded conv and its custom VJP (Pallas in interpret mode, as
``tests/test_banded_conv.py`` runs it), and training-mode BatchNorm
against ``batch_norm(..., training=True)``.

Tolerances: the banded conv's gradients at max|diff| <= 1e-3 x (max + 1),
both sides rounding the same operands to bf16 and summing in f32 in other
orders; pad rows of dX exactly 0. BatchNorm at f32 (rtol 1e-5, atol 1e-6)."""

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
from agile3d_torch.ops.norm import batch_norm_train
from agile3d_tpu.ops.banded_conv import banded_conv as jax_banded_conv
from agile3d_tpu.ops.banded_conv import banded_prep
from agile3d_tpu.ops.norm import BNState, batch_norm
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
