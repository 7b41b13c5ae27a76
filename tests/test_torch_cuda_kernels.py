"""The port's CUDA kernels against their plain PyTorch versions on the
card, at widths the main path does not use (odd channel counts, other
kernel volumes, ragged row counts), with random neighbour maps.

Needs a CUDA device and nvcc: marked ``cuda`` and skipped without a card.
The module imports torch and the port only, so on the GPU machine it runs
without JAX (and without the JAX conftest):

    python -m pytest tests/test_torch_cuda_kernels.py -p no:cacheprovider --noconftest -q
"""

import numpy as np
import pytest
import torch

from agile3d_torch.ops.banded_conv import (
    BandedConv,
    banded_conv,
    banded_conv_dw,
    banded_conv_dw_reference,
    banded_conv_reference,
)
from agile3d_torch.ops.banded_stem import (
    banded_stem_conv,
    banded_stem_conv_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, cin, cout, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, generator=g)
    nbr = torch.randint(-n // 2, n, (n, k), generator=g,
                        dtype=torch.int32).clamp(min=-1)
    nbr[-5:] = -1  # pad rows
    w = torch.randn(k, cin, cout, generator=g) * (k * cin) ** -0.5
    return x.to(device), nbr.to(device), w.to(device)


def _check(kernel, plain, x, nbr, w, counter):
    before = counter.launches
    y = kernel(x, nbr, w)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = plain(x, nbr, w)
    err = float((y - ref).abs().max())
    assert err <= 1e-3 * (float(ref.abs().max()) + 1.0), err
    assert float(y[-5:].abs().max()) == 0.0


@pytest.mark.parametrize("n,cin,cout,k", [
    (1000, 128, 96, 27), (300, 40, 200, 27), (777, 3, 20, 27),
    (5000, 64, 32, 8), (4000, 256, 130, 27), (130, 33, 7, 27),
    (2000, 16, 16, 125),
])
def test_banded_conv_matches_plain(card, n, cin, cout, k):
    x, nbr, w = _inputs(n, cin, cout, k, n + cin, card)
    _check(banded_conv, banded_conv_reference, x, nbr, w, banded_conv)


@pytest.mark.parametrize("n,cout", [(1000, 32), (777, 20), (3000, 40)])
def test_banded_stem_matches_plain(card, n, cout):
    x, nbr, w = _inputs(n, 3, cout, 125, n, card)
    _check(banded_stem_conv, banded_stem_conv_reference, x, nbr, w,
           banded_stem_conv)


def test_wrappers_refuse_bad_inputs(card):
    x, nbr, w = _inputs(100, 8, 8, 27, 0, card)
    with pytest.raises(TypeError):
        banded_conv(x.double(), nbr, w.double())
    with pytest.raises(TypeError):
        banded_conv(x, nbr.long(), w)
    with pytest.raises(ValueError):
        banded_conv(x, nbr[:, :8], w)
    with pytest.raises(ValueError):
        banded_conv(x, nbr, w.cpu())
    with pytest.raises(ValueError):
        banded_stem_conv(x, nbr, w)  # 27 offsets, 8 channels
    g = torch.randn(100, 8, device=card)
    with pytest.raises(TypeError):
        banded_conv_dw(x.double(), nbr, g.double())
    with pytest.raises(TypeError):
        banded_conv_dw(x, nbr.long(), g)
    with pytest.raises(ValueError):
        banded_conv_dw(x, nbr[:50], g)
    with pytest.raises(ValueError):
        banded_conv_dw(x, nbr, g.cpu())
    with pytest.raises(ValueError):
        banded_conv_dw(x, nbr, g.t())  # not contiguous


@pytest.mark.parametrize("n,cin,cout,k", [
    (1000, 128, 96, 27), (300, 40, 200, 27), (777, 3, 20, 27),
    (5000, 64, 32, 8), (4000, 256, 130, 27), (130, 33, 7, 27),
    (2000, 16, 16, 125), (20000, 96, 96, 27),
])
def test_banded_conv_dw_matches_plain(card, n, cin, cout, k):
    """Both sides round the same operands to bf16 and sum in f32 (the
    kernel in chunks, then over the chunks), so 1e-3 x (max + 1)."""
    x, nbr, _ = _inputs(n, cin, cout, k, n + cout, card)
    g = torch.randn(n, cout, generator=torch.Generator().manual_seed(n)).to(card)
    before = banded_conv_dw.launches
    dw = banded_conv_dw(x, nbr, g)
    torch.cuda.synchronize()
    assert banded_conv_dw.launches == before + 1
    ref = banded_conv_dw_reference(x, nbr, g)
    assert dw.shape == (k, cin, cout)
    err = float((dw - ref).abs().max())
    assert err <= 1e-3 * (float(ref.abs().max()) + 1.0), err
    # the two-pass sum has no atomics: the same inputs give the same bits
    assert torch.equal(banded_conv_dw(x, nbr, g), dw)


def test_banded_conv_function_matches_plain_function(card):
    """BandedConv forward and backward on the card against the same
    Function on the CPU (the plain versions of both kernels)."""
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    coords = np.random.default_rng(0).random((20000, 3)).astype(np.float32)
    vox, _, _ = sparse_quantize(coords * 1.2, 0.05)
    k3 = torch.from_numpy(build_pyramid(vox).levels[0].k3)
    n = k3.shape[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, 96, generator=g)
    w = torch.randn(27, 96, 64, generator=g) * 0.05
    tgt = torch.randn(n, 64, generator=g)
    grads = []
    for dev in ("cpu", card):
        xd = x.to(dev, copy=True).requires_grad_()
        wd = w.to(dev, copy=True).requires_grad_()
        y = BandedConv.apply(xd, k3.to(dev), wd)
        ((y - tgt.to(dev)) ** 2).sum().backward()
        grads.append((y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
    for name, a, b in zip(("y", "dx", "dw"), grads[0], grads[1]):
        err = float((a - b).abs().max())
        assert err <= 1e-3 * (float(a.abs().max()) + 1.0), (name, err)
