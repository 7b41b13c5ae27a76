"""Plain versions of the port's two CUDA kernels against the JAX Pallas
kernels they replace (run in interpret mode on the CPU, as the JAX
package's own tests run them).

Both sides round the operands to bf16 and sum in f32, in different orders,
so the tolerance is max|diff| <= 1e-3 * (max|ref| + 1). On CPU tensors the
wrappers must take the plain version (the kernels themselves are checked
on the card by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_tpu.config import Config
from agile3d_tpu.ops.banded_conv import banded_conv as jax_banded_conv
from agile3d_tpu.ops.banded_conv import banded_prep
from agile3d_tpu.ops.banded_stem import banded_stem_conv as jax_banded_stem_conv
from agile3d_tpu.ops.banded_stem import stem_banded_prep
from agile3d_tpu.sparse import build_pyramid as jax_build_pyramid
from agile3d_tpu.sparse import pad_pyramid as jax_pad_pyramid
from agile3d_tpu.sparse.quantize import sparse_quantize as jax_sparse_quantize
from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_reference
from agile3d_torch.ops.banded_stem import (
    banded_stem_conv,
    banded_stem_conv_reference,
)
from tests.synthetic import make_scene
from tests.test_banded_conv import _small_padded_k3

torch.set_num_threads(1)


def _close(got, ref):
    err = float(np.abs(got - ref).max())
    assert err <= 1e-3 * (float(np.abs(ref).max()) + 1.0), err


@pytest.mark.parametrize("cin,cout", [(96, 96), (128, 96)])
def test_banded_conv_plain_matches_jax_kernel(cin, cout):
    lvl = _small_padded_k3()
    k3 = lvl.k3
    n = k3.shape[0]
    assert n == 2048
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((n, cin)).astype(np.float32)
    x[~lvl.valid] = 0.0
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * 0.1
    w0_t, lo_t, exc_t, ok = banded_prep(k3)
    assert ok
    ref = np.asarray(jax_banded_conv(jnp.asarray(x), jnp.asarray(k3),
                                     jnp.asarray(lo_t), jnp.asarray(w0_t),
                                     jnp.asarray(w), exc=exc_t))

    xt, k3t, wt = torch.from_numpy(x), torch.from_numpy(k3), torch.from_numpy(w)
    got = banded_conv_reference(xt, k3t, wt).numpy()
    _close(got, ref)
    assert np.abs(got[~lvl.valid]).max() == 0.0
    # the wrapper takes the plain version for CPU tensors, and only that
    launches = banded_conv.launches
    np.testing.assert_array_equal(banded_conv(xt, k3t, wt).numpy(), got)
    assert banded_conv.launches == launches


def _stem_level():
    """The scene of tests/test_banded_stem.py (24,576-row bucket)."""
    rng = np.random.default_rng(3)
    coords, _, _ = make_scene(rng, n_points=30000, num_obj=4)
    vox, _, _ = jax_sparse_quantize(coords, Config().model.voxel_size)
    pyr = jax_pad_pyramid(jax_build_pyramid(vox), buckets=Config().buckets,
                          stem_banded=False)
    return pyr.levels[0], rng


def test_banded_stem_plain_matches_jax_kernel():
    lv, rng = _stem_level()
    n = lv.grid.shape[0]
    x = np.zeros((n, 3), np.float32)
    x[: lv.num_valid] = rng.standard_normal((lv.num_valid, 3))
    w = rng.standard_normal((125, 3, 32)).astype(np.float32) * 0.1
    w0, lo, r0, rank, exc, ok = stem_banded_prep(lv.k5)
    assert ok
    ref = np.asarray(jax_banded_stem_conv(
        jnp.asarray(x), jnp.asarray(r0), jnp.asarray(rank), jnp.asarray(w0),
        jnp.asarray(lo), None if exc is None else jnp.asarray(exc),
        jnp.asarray(w)))

    xt, k5t, wt = torch.from_numpy(x), torch.from_numpy(lv.k5), torch.from_numpy(w)
    got = banded_stem_conv_reference(xt, k5t, wt).numpy()
    _close(got, ref)
    assert np.abs(got[lv.num_valid:]).max() == 0.0
    launches = banded_stem_conv.launches
    np.testing.assert_array_equal(banded_stem_conv(xt, k5t, wt).numpy(), got)
    assert banded_stem_conv.launches == launches


def test_plain_versions_round_operands_to_bf16():
    """Inputs exactly representable in bf16 give the exact f32 sum; one
    extra mantissa bit below bf16 is rounded away."""
    x = torch.tensor([[1.0 + 2 ** -9, 2.0], [0.0, 0.0]])
    k3 = torch.tensor([[0, -1], [-1, -1]], dtype=torch.int32)
    w = torch.ones((2, 2, 1))
    y = banded_conv_reference(x, k3, w)
    assert y[0, 0].item() == 3.0 and y[1, 0].item() == 0.0


@pytest.mark.parametrize("n,k,cin,cout,want", [
    (524288, 27, 128, 96, 8192), (524288, 27, 96, 96, 8192),
    (131072, 27, 96, 96, 6912), (1000, 27, 128, 96, 512),
    (50, 27, 96, 128, 64), (2000, 125, 16, 16, 512),
])
def test_dw_chunk_is_whole_stages(n, k, cin, cout, want):
    """The dW kernel's rows per CTA: whole 64-row stages, at most
    DW_MAX_CHUNK, and (above 512 rows a chunk) about two waves of CTAs on
    132 SMs; pinned at the training shapes."""
    from agile3d_torch.ops.banded_conv import DW_MAX_CHUNK, dw_chunk, dw_tile_n

    chunk = dw_chunk(n, k, cin, cout)
    assert chunk == want
    assert chunk % 64 == 0 and 64 <= chunk <= DW_MAX_CHUNK
    ctas = -(-n // chunk) * -(-k // 2) * -(-cin // 128) * -(-cout // dw_tile_n(cout))
    assert chunk == 512 or chunk >= n or ctas >= 264 or chunk == DW_MAX_CHUNK


def test_kernel_tiles_and_image_sizes():
    """Scratch sizes the wrappers allocate for the kernels' shared-memory
    images, from the tile widths the sources choose."""
    from agile3d_torch.ops.banded_conv import (
        conv_cinp,
        conv_tile_n,
        dw_tile_n,
        row_image_numel,
        weight_image_numel,
    )

    assert [conv_tile_n(c) for c in (1, 32, 33, 96, 97, 128, 200)] == \
        [32, 32, 64, 96, 128, 128, 128]
    assert [dw_tile_n(c) for c in (7, 64, 65, 96, 128, 200)] == \
        [64, 64, 96, 96, 128, 128]
    assert [conv_cinp(c) for c in (3, 16, 33, 96, 128)] == [16, 16, 48, 96, 128]
    # 27 offsets x 2 slices of 64 channels, one 96-column tile
    assert weight_image_numel(27, 128, 96) == 27 * 2 * 96 * 64
    # cin 96: slices of 64 and 32 channels, each a 64-channel run
    assert weight_image_numel(27, 96, 128) == 27 * 2 * 128 * 64
    # cout 200: two 128-column tiles
    assert weight_image_numel(8, 40, 200) == 2 * 8 * 1 * 128 * 64
    # rows padded to 64; cout 96 takes two 64-column atoms, 200 four
    assert row_image_numel(1000, 96) == 1024 * 2 * 64
    assert row_image_numel(64, 200) == 64 * 4 * 64


def test_transposed_conv_reads_flipped_weights():
    """dX's form on the CPU: transposed=True with a forward's [k, cout,
    cin] weights is the conv with flip(w, 0).transpose(1, 2), and
    BandedConv's dX is that conv of the cotangent."""
    from agile3d_torch.ops.banded_conv import BandedConv

    rng = np.random.default_rng(5)
    n, cin, cout = 300, 12, 20
    k3 = torch.from_numpy(rng.integers(-1, n, (n, 27)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((27, cin, cout)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, cout)).astype(np.float32))
    launches = banded_conv.launches
    got = banded_conv(g, k3, w, transposed=True)
    ref = banded_conv_reference(g, k3, w.flip(0).transpose(1, 2).contiguous())
    assert torch.equal(got, ref)
    xg = x.clone().requires_grad_()
    BandedConv.apply(xg, k3, w).backward(g)
    assert torch.equal(xg.grad, ref)
    assert banded_conv.launches == launches
