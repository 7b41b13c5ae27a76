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
from agile3d_torch.ops.banded_window import (
    banded_window_conv,
    banded_window_conv_reference,
    window_plan,
)
from agile3d_torch.ops.row_gather import (
    row_gather_reference,
    smem_row_gather,
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
    # three 256-row tiles, the last one partial
    (700, 96, 96, 27), (700, 128, 96, 27),
    # fewer rows than one tile; dX's width (cout 128); cin 33 and 96
    (100, 64, 128, 27), (1500, 96, 128, 27), (900, 33, 96, 27),
])
def test_banded_conv_matches_plain(card, n, cin, cout, k):
    x, nbr, w = _inputs(n, cin, cout, k, n + cin, card)
    _check(banded_conv, banded_conv_reference, x, nbr, w, banded_conv)


@pytest.mark.parametrize("points,cin,cout", [
    (20000, 96, 96), (20000, 128, 96), (20000, 96, 128), (8000, 33, 200),
])
def test_banded_conv_on_scene_maps(card, points, cin, cout):
    """Banded maps of sorted voxels, where each dx's window of rows fits
    in shared memory (on the random maps above every window is too long,
    so each CTA falls back to its gathered rows)."""
    k3 = _scene_k3(points, cin)
    g = torch.Generator().manual_seed(points + cout)
    x = torch.randn(k3.shape[0], cin, generator=g)
    x[-300:] = 0.0
    w = torch.randn(27, cin, cout, generator=g) * (27 * cin) ** -0.5
    x, k3, w = x.to(card), k3.to(card), w.to(card)
    y = banded_conv(x, k3, w)
    torch.cuda.synchronize()
    ref = banded_conv_reference(x, k3, w)
    err = float((y - ref).abs().max())
    assert err <= 1e-3 * (float(ref.abs().max()) + 1.0), err
    assert float(y[-300:].abs().max()) == 0.0


def _absent_tiles(nbr):
    """Every other 64-row tile of the map absent, and no neighbour in the
    rows of the tiles after them."""
    nbr = nbr.clone()
    n = nbr.shape[0]
    for r0 in range(0, n, 128):
        nbr[r0:r0 + 64] = -1
    keep = (torch.arange(n, device=nbr.device) // 64) % 2 == 1
    nbr[~keep[nbr.clamp(min=0).long()] & (nbr >= 0)] = -1
    return nbr


@pytest.mark.parametrize("cin,cout", [(128, 96), (96, 128)])
def test_banded_conv_with_absent_tiles(card, cin, cout):
    x, nbr, w = _inputs(1300, cin, cout, 27, 7, card)
    nbr = _absent_tiles(nbr)
    _check(banded_conv, banded_conv_reference, x, nbr, w, banded_conv)
    y = banded_conv(x, nbr, w)
    torch.cuda.synchronize()
    assert float(y[:64].abs().max()) == 0.0


@pytest.mark.parametrize("n,cin,cout", [(1000, 128, 96), (700, 96, 96),
                                        (300, 33, 200)])
def test_banded_conv_transposed_matches_flipped_weights(card, n, cin, cout):
    """dX's form: the forward's [k, cout, cin] weights read as
    flip(w, 0).transpose(1, 2) by the weight cast."""
    x, nbr, w = _inputs(n, cin, cout, 27, n, card)
    wf = w.transpose(1, 2).flip(0).contiguous()  # a forward's [k, cout, cin]
    before = banded_conv.launches
    y = banded_conv(x, nbr, wf, transposed=True)
    torch.cuda.synchronize()
    assert banded_conv.launches == before + 1
    ref = banded_conv_reference(x, nbr, w)
    assert float((y - ref).abs().max()) <= 1e-3 * (float(ref.abs().max()) + 1.0)
    assert float(y[-5:].abs().max()) == 0.0


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
    # an odd number of offsets (k 5, 125: a warpgroup with no offset);
    # fewer rows than a stage; cin 96 and 33 with cout 128
    (900, 96, 96, 5), (50, 96, 128, 27), (3000, 33, 128, 27),
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


def test_banded_conv_dw_with_absent_tiles(card):
    x, nbr, _ = _inputs(9000, 128, 96, 27, 3, card)
    nbr = _absent_tiles(nbr)
    g = torch.randn(9000, 96, generator=torch.Generator().manual_seed(3)).to(card)
    dw = banded_conv_dw(x, nbr, g)
    torch.cuda.synchronize()
    ref = banded_conv_dw_reference(x, nbr, g)
    assert float((dw - ref).abs().max()) <= 1e-3 * (float(ref.abs().max()) + 1.0)
    assert torch.equal(banded_conv_dw(x, nbr, g), dw)


@pytest.mark.parametrize("cin,cout", [(96, 64), (96, 128)])
def test_banded_conv_function_matches_plain_function(card, cin, cout):
    """BandedConv forward and backward on the card against the same
    Function on the CPU (the plain versions of both kernels); 96 -> 128
    is the shape whose dX is the eval path's 128 -> 96."""
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    coords = np.random.default_rng(0).random((20000, 3)).astype(np.float32)
    vox, _, _ = sparse_quantize(coords * 1.2, 0.05)
    k3 = torch.from_numpy(build_pyramid(vox).levels[0].k3)
    n = k3.shape[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g) * 0.05
    tgt = torch.randn(n, cout, generator=g)
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


def _scene_k3(points, seed):
    """A level-0 map of sorted voxels (banded) with 300 pad rows."""
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    coords = np.random.default_rng(seed).random((points, 3)).astype(np.float32)
    vox, _, _ = sparse_quantize(coords * 1.5, 0.05)
    k3 = build_pyramid(vox).levels[0].k3
    return torch.from_numpy(np.concatenate(
        [k3, np.full((300, 27), -1, np.int32)]))


@pytest.mark.parametrize("points,cin,cout,max_rows", [
    (20000, 96, 96, None), (20000, 128, 96, None), (20000, 40, 200, None),
    (8000, 3, 20, None), (8000, 256, 130, 150), (20000, 96, 96, 100),
    (0, 64, 32, None),
])
def test_banded_window_matches_plain(card, points, cin, cout, max_rows):
    """Banded scene maps (and, at 0 points, a random map whose windows span
    its whole 700 rows); a max_rows cap drops the neighbours past it."""
    if points:
        k3 = _scene_k3(points, cin)
    else:
        k3 = _inputs(700, 1, 1, 27, 0, "cpu")[1]
        k3[-300:] = -1
    plan = window_plan(k3, max_rows=max_rows)
    assert plan.covers == (max_rows is None)
    n = k3.shape[0]
    g = torch.Generator().manual_seed(n + cin)
    x = torch.randn(n, cin, generator=g)
    x[-300:] = 0.0
    w = torch.randn(27, cin, cout, generator=g) * (27 * cin) ** -0.5
    x, k3, w, plan = x.to(card), k3.to(card), w.to(card), plan.to(card)
    before = banded_window_conv.launches
    y = banded_window_conv(x, k3, plan, w)
    torch.cuda.synchronize()
    assert banded_window_conv.launches == before + 1
    ref = banded_window_conv_reference(x, k3, plan, w)
    err = float((y - ref).abs().max())
    assert err <= 1e-3 * (float(ref.abs().max()) + 1.0), err
    assert float(y[-300:].abs().max()) == 0.0
    if plan.covers:
        full = banded_conv_reference(x, k3, w)
        assert float((y - full).abs().max()) <= 1e-3 * (
            float(full.abs().max()) + 1.0)


def test_banded_window_refuses_a_window_that_does_not_fit(card):
    x, k3, w = _inputs(5000, 128, 96, 27, 1, card)
    plan = window_plan(k3)  # random neighbours: windows of ~5,000 rows
    with pytest.raises(ValueError):
        banded_window_conv(x, k3, plan.to(card), w)
    with pytest.raises(ValueError):
        banded_window_conv(x, k3, plan, w)  # the plan is on the CPU


@pytest.mark.parametrize("w,c,m", [(384, 128, 27 * 1024), (100, 4, 1000),
                                   (1, 8, 5), (3000, 16, 70000)])
def test_smem_row_gather_equals_indexing(card, w, c, m):
    g = torch.Generator().manual_seed(w + m)
    x = torch.randn(w, c, generator=g).to(card)
    idx = torch.randint(0, w, (m,), generator=g, dtype=torch.int32).to(card)
    before = smem_row_gather.launches
    out = smem_row_gather(x, idx)
    torch.cuda.synchronize()
    assert smem_row_gather.launches == before + 1
    assert torch.equal(out, row_gather_reference(x, idx))


def test_smem_row_gather_refuses_bad_inputs(card):
    idx = torch.zeros(10, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(4096, 128, device=card), idx)  # 2 MB
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(10, 3, device=card), idx)
    with pytest.raises(TypeError):
        smem_row_gather(torch.zeros(10, 4, device=card), idx.long())
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(10, 4, device=card), idx.cpu())
