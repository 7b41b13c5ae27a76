"""The port's CUDA kernels against their plain PyTorch versions on the
card, at widths the main path does not use (odd channel counts, other
kernel volumes, ragged row counts), with random neighbour maps.

Needs a CUDA device and nvcc: marked ``cuda`` and skipped without a card.
The module imports torch and the port only, so on the GPU machine it runs
without JAX (and without the JAX conftest):

    python -m pytest tests/test_torch_cuda_kernels.py -p no:cacheprovider --noconftest -q
"""

import pytest
import torch

from agile3d_torch.ops.banded_conv import banded_conv, banded_conv_reference
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
