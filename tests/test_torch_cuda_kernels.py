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
    stem_prep,
    stem_weight_image_numel,
)
from agile3d_torch.ops.banded_window import (
    banded_window_conv,
    banded_window_conv_reference,
    max_window_rows,
    window_layout,
    window_mask,
    window_plan,
)
from agile3d_torch.engine.device_eval import error_clusters
from agile3d_torch.ops.boundary_dist import (
    boundary_distances_all,
    boundary_distances_all_reference,
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


@pytest.mark.parametrize("n,cout", [
    (1000, 32), (777, 20), (3000, 40),
    # a row count that 4 does not divide (a ragged last tile whose k5 run
    # is not 16-byte sized), fewer rows than one 64-row tile, cout 64
    (1001, 32), (50, 32), (2000, 64),
])
def test_banded_stem_matches_plain(card, n, cout):
    x, nbr, w = _inputs(n, 3, cout, 125, n, card)
    _check(banded_stem_conv, banded_stem_conv_reference, x, nbr, w,
           banded_stem_conv)


@pytest.mark.parametrize("n,cout", [(1001, 32), (50, 40)])
def test_stem_prep_casts_rows_and_weights(card, n, cout):
    """The prep pass: x as bf16 rows of 4 channels (the 4th 0) with a zero
    row after them, and every weight once in the image, rounded to bf16,
    the padding 0."""
    x, _, w = _inputs(n, 3, cout, 125, 7, card)
    xb, wimg = stem_prep(x, w)
    torch.cuda.synchronize()
    assert xb.shape == (n + 1, 4)
    assert torch.equal(xb[:n, :3], x.to(torch.bfloat16))
    assert float(xb[:, 3].abs().max()) == 0.0 and float(xb[n].abs().max()) == 0.0
    assert wimg.numel() == stem_weight_image_numel(cout)
    img = wimg.float()
    assert int((img != 0).sum()) == w.numel()
    assert torch.equal(img[img != 0].sort().values,
                       w.to(torch.bfloat16).float().flatten().sort().values)


def _scene_k5(points, seed):
    """The stem's level-0 map of sorted voxels with 300 pad rows."""
    from agile3d_torch.sparse.kernel_maps import build_pyramid
    from agile3d_torch.sparse.quantize import sparse_quantize

    coords = np.random.default_rng(seed).random((points, 3)).astype(np.float32)
    vox, _, _ = sparse_quantize(coords * 1.5, 0.05)
    k5 = build_pyramid(vox).levels[0].k5
    return torch.from_numpy(np.concatenate(
        [k5, np.full((300, 125), -1, np.int32)]))


@pytest.mark.parametrize("points,cout", [(20000, 32), (8000, 20), (8000, 40),
                                         (20000, 64)])
def test_banded_stem_on_scene_maps(card, points, cout):
    """Sorted scene maps, where the neighbours of a tile's rows lie near
    each other (the main path's case)."""
    k5 = _scene_k5(points, cout)
    g = torch.Generator().manual_seed(points + cout)
    x = torch.randn(k5.shape[0], 3, generator=g)
    x[-300:] = 0.0
    w = torch.randn(125, 3, cout, generator=g) * 375 ** -0.5
    x, k5, w = x.to(card), k5.to(card), w.to(card)
    _check(banded_stem_conv, banded_stem_conv_reference, x, k5, w,
           banded_stem_conv)


def test_banded_stem_with_absent_tiles(card):
    """Every other 64-row tile absent: those rows come out exactly 0."""
    x, nbr, w = _inputs(1300, 3, 32, 125, 11, card)
    nbr = _absent_tiles(nbr)
    _check(banded_stem_conv, banded_stem_conv_reference, x, nbr, w,
           banded_stem_conv)
    y = banded_stem_conv(x, nbr, w)
    torch.cuda.synchronize()
    for r0 in range(0, 1300, 128):
        assert float(y[r0:r0 + 64].abs().max()) == 0.0


def test_banded_stem_refuses_an_unaligned_map(card):
    """k5 is read by bulk copy from 16-byte boundaries: a view that starts
    one row into a buffer (500 bytes) is refused, not copied."""
    x, nbr, w = _inputs(200, 3, 32, 125, 2, card)
    buf = torch.cat([nbr[:1], nbr])
    view = buf[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    before = banded_stem_conv.launches
    with pytest.raises(ValueError, match="16-byte"):
        banded_stem_conv(x, view, w)
    assert banded_stem_conv.launches == before
    assert torch.equal(banded_stem_conv(x, view.clone(), w),
                       banded_stem_conv(x, nbr, w))


BF16 = torch.bfloat16
# (x dtype, w or g dtype): the pairs the bf16 backbone gives the kernels
DTYPE_PAIRS = [(BF16, BF16), (torch.float32, BF16), (BF16, torch.float32)]


@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("n,cin,cout,k", [
    (1000, 128, 96, 27), (777, 3, 20, 27), (4000, 256, 130, 27),
    (130, 33, 7, 27), (2000, 16, 16, 125)])
def test_banded_conv_bf16_operands_equal_the_f32_launch(card, xd, wd, n, cin,
                                                        cout, k):
    """A bf16 operand casts to itself: the launch equals the f32 launch on
    its values bit for bit, cast to x's dtype; forward and dX."""
    x, nbr, w = _inputs(n, cin, cout, k, n + cin, card)
    x, w = x.to(xd), w.to(wd)
    before = banded_conv.launches
    y = banded_conv(x, nbr, w)
    assert banded_conv.launches == before + 1 and y.dtype == xd
    assert torch.equal(y, banded_conv(x.float(), nbr, w.float()).to(xd))
    wt = w.transpose(1, 2).contiguous()   # a forward's [k, cout, cin]
    dx = banded_conv(x, nbr, wt, transposed=True)
    assert torch.equal(
        dx, banded_conv(x.float(), nbr, wt.float(), transposed=True).to(xd))
    # and the f32 launch on those values against the plain version
    _check(banded_conv, banded_conv_reference, x.float(), nbr, w.float(),
           banded_conv)


@pytest.mark.parametrize("xd,gd", DTYPE_PAIRS)
@pytest.mark.parametrize("n,cin,cout,k", [(3000, 96, 128, 27),
                                          (900, 96, 96, 5), (50, 33, 128, 27)])
def test_banded_conv_dw_bf16_operands_equal_the_f32_launch(card, xd, gd, n,
                                                           cin, cout, k):
    x, nbr, _ = _inputs(n, cin, cout, k, n + cout, card)
    g = torch.randn(n, cout, generator=torch.Generator().manual_seed(n)).to(card)
    x, g = x.to(xd), g.to(gd)
    dw = banded_conv_dw(x, nbr, g)
    assert dw.dtype == torch.float32
    assert torch.equal(dw, banded_conv_dw(x.float(), nbr, g.float()))


@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("n,cout", [(3000, 32), (50, 40)])
def test_banded_stem_bf16_operands_equal_the_f32_launch(card, xd, wd, n, cout):
    x, nbr, w = _inputs(n, 3, cout, 125, n, card)
    x, w = x.to(xd), w.to(wd)
    y = banded_stem_conv(x, nbr, w)
    assert y.dtype == xd
    assert torch.equal(y, banded_stem_conv(x.float(), nbr, w.float()).to(xd))
    xb, wimg = stem_prep(x, w)
    xb32, wimg32 = stem_prep(x.float(), w.float())
    assert torch.equal(xb, xb32) and torch.equal(wimg, wimg32)


def test_banded_conv_function_in_bf16(card):
    """BandedConv under the bf16 backbone's training dtypes: dX in x's
    dtype, dW in w's, each the f32 launches on the same values."""
    x, nbr, w = _inputs(2000, 96, 96, 27, 7, card)
    xb = x.to(BF16).requires_grad_()
    wb = w.to(BF16).requires_grad_()
    y = BandedConv.apply(xb, nbr, wb)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(card)
    y.backward(g.to(BF16))
    assert y.dtype == xb.grad.dtype == wb.grad.dtype == BF16
    want_dx = banded_conv(g.to(BF16).float(), nbr, wb.detach().float(),
                          transposed=True)
    assert torch.equal(xb.grad, want_dx.to(BF16))
    want_dw = banded_conv_dw(xb.detach().float(), nbr, g.to(BF16).float())
    assert torch.equal(wb.grad, want_dw.to(BF16))


def test_wrappers_refuse_bad_inputs(card):
    x, nbr, w = _inputs(100, 8, 8, 27, 0, card)
    with pytest.raises(TypeError):
        banded_conv(x.double(), nbr, w.double())
    with pytest.raises(TypeError):
        banded_conv(x.half(), nbr, w)
    with pytest.raises(TypeError):
        banded_stem_conv(x[:, :3].contiguous().half(), nbr.repeat(1, 5)[:, :125]
                         .contiguous(), torch.zeros(125, 3, 8, device=card))
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


def _window_check(card, k3, plan, cin, cout, seed):
    """The window kernel against its plain version on k3 under ``plan``;
    the result."""
    n = k3.shape[0]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g) * (27 * cin) ** -0.5
    x, k3, w, plan = x.to(card), k3.to(card), w.to(card), plan.to(card)
    before = banded_window_conv.launches
    y = banded_window_conv(x, k3, plan, w)
    torch.cuda.synchronize()
    assert banded_window_conv.launches == before + 1
    ref = banded_window_conv_reference(x, k3, plan, w)
    err = float((y - ref).abs().max())
    assert err <= 1e-3 * (float(ref.abs().max()) + 1.0), err
    return y


@pytest.mark.parametrize("cin", [96, 128])
def test_banded_window_at_the_longest_window(card, cin):
    """A random map's windows capped at max_window_rows: every CTA's slot
    holds two windows of the longest length the kernel takes (one slot),
    and the neighbours past the cap drop out."""
    k3 = _inputs(3000, 1, 1, 27, cin, "cpu")[1]
    cap = max_window_rows(27, 96)
    plan = window_plan(k3, max_rows=cap)
    assert plan.max_length == cap and not plan.covers
    assert window_layout(27, 96, cap)[0] == 1
    _window_check(card, k3, plan, cin, 96, cin)


def test_banded_window_drops_neighbours_outside_capped_windows(card):
    """A scene map with its windows capped below their length: the kernel
    drops the neighbours past the cap as the plain version does, and keeps
    the rest."""
    k3 = _scene_k3(20000, 3)
    plan = window_plan(k3, max_rows=window_plan(k3).max_length // 2)
    mask = window_mask(k3, plan)
    outside = int(((k3 >= 0) & ~mask).sum())
    assert outside > 0 and int(mask.sum()) > outside
    y = _window_check(card, k3, plan, 96, 96, 4)
    assert float(y[-300:].abs().max()) == 0.0


@pytest.mark.parametrize("cin,cout", [(96, 96), (128, 64)])
def test_banded_window_with_an_empty_plan_block(card, cin, cout):
    """A 256-row CTA whose second 128-row plan block has no neighbour (no
    window), and one whose first has none: those rows come out exactly 0,
    the other block's as the plain version."""
    k3 = _scene_k3(20000, 5).clone()
    k3[384:512] = -1    # block 3: CTA 1's second block
    k3[1024:1152] = -1  # block 8: CTA 4's first block
    plan = window_plan(k3)
    assert plan.covers
    assert int(plan.length[3].max()) == 0 and int(plan.length[8].max()) == 0
    assert int(plan.length[2].max()) > 0 and int(plan.length[9].max()) > 0
    y = _window_check(card, k3, plan, cin, cout, 6)
    assert float(y[384:512].abs().max()) == 0.0
    assert float(y[1024:1152].abs().max()) == 0.0
    assert float(y[256:384].abs().max()) > 0.0


def test_banded_window_refuses_a_window_that_does_not_fit(card):
    x, k3, w = _inputs(5000, 128, 96, 27, 1, card)
    plan = window_plan(k3)  # random neighbours: windows of ~5,000 rows
    with pytest.raises(ValueError):
        banded_window_conv(x, k3, plan.to(card), w)
    with pytest.raises(ValueError):
        banded_window_conv(x, k3, plan, w)  # the plan is on the CPU


@pytest.mark.parametrize("w,c,m", [(384, 128, 27 * 1024), (100, 4, 1000),
                                   (1, 8, 5), (3000, 16, 70000),
                                   (4096, 128, 27 * 1024), (7000, 128, 3000)])
def test_smem_row_gather_equals_indexing(card, w, c, m):
    g = torch.Generator().manual_seed(w + m)
    x = torch.randn(w, c, generator=g).to(card)
    idx = torch.randint(0, w, (m,), generator=g, dtype=torch.int32).to(card)
    before = smem_row_gather.launches
    out = smem_row_gather(x, idx)
    torch.cuda.synchronize()
    assert smem_row_gather.launches == before + 1
    assert torch.equal(out, row_gather_reference(x, idx))


@pytest.mark.parametrize("w", [384, 4096])
@pytest.mark.parametrize("m", [27 * 1024, 32, 1000, 33 * 1024 + 7, 300000])
def test_smem_row_gather_over_grid_sizes(card, w, m):
    """The TPU probe's tables over grids of one 16-CTA cluster up to as
    many as the card holds (the row count sets the grid): a CTA that left
    while a peer still read its slice would show here as wrong rows."""
    g = torch.Generator().manual_seed(w * 7 + m)
    x = torch.randn(w, 128, generator=g).to(card)
    idx = torch.randint(0, w, (m,), generator=g, dtype=torch.int32).to(card)
    ref = row_gather_reference(x, idx)
    for _ in range(3):
        out = smem_row_gather(x, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_smem_row_gather_writes_zero_rows_for_bad_indices(card):
    x = torch.randn(4096, 128, device=card) + 5.0
    idx = torch.tensor([0, -1, 4096, 4095, 1 << 30], dtype=torch.int32,
                       device=card)
    out = smem_row_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out[0], x[0]) and torch.equal(out[3], x[4095])
    assert float(out[[1, 2, 4]].abs().max()) == 0.0


def test_smem_row_gather_refuses_bad_inputs(card):
    idx = torch.zeros(10, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="3718912 bytes"):
        smem_row_gather(torch.zeros(8192, 128, device=card), idx)  # 4 MB
    with pytest.raises(ValueError):  # 454 rows a CTA: 232,448 bytes
        smem_row_gather(torch.zeros(7249, 128, device=card), idx)
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(10, 3, device=card), idx)
    with pytest.raises(TypeError):
        smem_row_gather(torch.zeros(10, 4, device=card), idx.long())
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(10, 4, device=card), idx.cpu())
    with pytest.raises(ValueError):
        smem_row_gather(torch.zeros(10, 8, device=card)[:, :4], idx)
    with pytest.raises(ValueError):  # not 16-byte aligned
        smem_row_gather(torch.zeros(41, device=card)[1:].view(10, 4), idx)


def _rollout_case(b, n, valid_frac, n_cl, seed, device):
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand(b, n, 3, generator=g) * 8
    valid = torch.rand(b, n, generator=g) < valid_frac
    cluster = torch.randint(-1, n_cl, (b, n), generator=g, dtype=torch.int32)
    return coords.to(device), cluster.to(device), valid.to(device)


@pytest.mark.parametrize("b,n,valid_frac,n_cl", [
    (1, 196608, 0.92, 9),      # an eval round of the smoke scene
    (5, 131072, 0.72, 11),     # a training round of the batch of five
    (1, 70001, 0.9, 121),      # ragged: no tile, chunk or block fills
    (2, 777, 0.5, 3), (3, 33, 1.0, 2), (1, 1, 1.0, 1),
    (1, 4096, 0.0, 5),         # every row invalid: inf
    (1, 50000, 1.0, 1),        # one cluster only: inf
])
def test_boundary_distances_equal_plain_bitwise(card, b, n, valid_frac, n_cl):
    coords, cluster, valid = _rollout_case(b, n, valid_frac, n_cl, n + b,
                                           card)
    if n_cl == 1:
        cluster.zero_()
    before = boundary_distances_all.launches
    d = boundary_distances_all(coords, cluster, valid)
    torch.cuda.synchronize()
    assert boundary_distances_all.launches == before + 1
    ref = boundary_distances_all_reference(coords, cluster, valid)
    assert torch.equal(d, ref), int((d != ref).sum())
    if valid_frac == 0.0 or n_cl == 1:
        assert torch.isinf(d).all()


def _sorted_scene(n, n_obj, seed, device):
    """Rows sorted by (x, y, z) on a 0.05 grid, as voxel rows come: points
    of n_obj balls (clusters 0..n_obj-1) in a background (-1)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3)) * 8
    centres = rng.random((n_obj, 3)) * 8
    cl = np.full(n, -1, np.int32)
    for o, c in enumerate(centres):
        cl[np.linalg.norm(pts - c, axis=1) < 0.8] = o
    order = np.lexsort(np.floor(pts / 0.05).T[::-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(pts[order].astype(np.float32)), t(cl[order])


@pytest.mark.parametrize("b,n,n_obj,query_frac", [
    (1, 196608, 8, None),      # sorted rows: the error clusters queried
    (2, 98304, 6, None),
    (1, 70001, 5, 0.3),        # a random query mask
    (3, 1000, 2, 0.0),         # nothing queried: +inf everywhere
    (2, 777, 1, 1.0),          # everything queried
])
def test_boundary_distances_of_query_rows_equal_plain(card, b, n, n_obj,
                                                      query_frac):
    """The main path's call: sorted rows (culling at work), the query a
    mask; bit for bit the plain version, +inf outside the query, and the
    pairs counter at most the all-pairs count (exactly it for a single
    query tile's worth of keys)."""
    from agile3d_torch.ops.boundary_dist import all_pairs

    items = [_sorted_scene(n, n_obj, s, card) for s in range(b)]
    coords = torch.stack([c for c, _ in items])
    cluster = torch.stack([c for _, c in items])
    g = torch.Generator().manual_seed(n)
    valid = (torch.rand(b, n, generator=g) < 0.95).to(card)
    query = (cluster >= 0) & valid if query_frac is None else (
        torch.rand(b, n, generator=g) < query_frac).to(card)
    pairs = torch.zeros(1, dtype=torch.int64, device=card)
    before = boundary_distances_all.launches
    d = boundary_distances_all(coords, cluster, valid, query, pairs=pairs)
    torch.cuda.synchronize()
    assert boundary_distances_all.launches == before + 1
    ref = boundary_distances_all_reference(coords, cluster, valid, query)
    assert torch.equal(d, ref), int((d != ref).sum())
    assert torch.isinf(d[~query]).all()
    assert 0 <= int(pairs) <= all_pairs(valid, query)
    if query_frac == 0.0:
        assert int(pairs) == 0


def _snapped_scene(n, seed, device):
    """Sorted rows on a coarse 0.125 grid (exact ties everywhere, boxes
    that touch and coincide), signed zeros, and duplicate points in
    different clusters (distance 0): clusters are balls of the grid
    points, the background -1."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(-20, 21, (n, 3))
    pts = grid.astype(np.float32) * np.float32(0.125)
    cl = np.full(n, -1, np.int32)
    for o, c in enumerate(rng.integers(-16, 17, (4, 3)) * 0.125):
        cl[np.linalg.norm(pts - c, axis=1) < 1.0] = o
    dup = rng.choice(n, n // 20, replace=False)
    src = rng.choice(n, n // 20, replace=False)
    grid[dup], pts[dup] = grid[src], pts[src]
    cl[dup] = (cl[src] + 1 + rng.integers(0, 4, n // 20)) % 5 - 1
    pts[(pts == 0) & (rng.random(pts.shape) < 0.5)] = np.float32(-0.0)
    order = np.lexsort(grid.T[::-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(pts[order]), t(cl[order])


@pytest.mark.parametrize("b,n,queried", [
    (1, 50000, True), (3, 4099, True), (1, 50000, False), (2, 777, False),
])
def test_boundary_distances_on_snapped_floats_equal_plain(card, b, n,
                                                          queried):
    """Ties, touching boxes, -0.0 and zero distances across clusters
    through the kernel's bound, its warp-wide group test and its >= skip:
    bit for bit the plain version, with and without the query mask."""
    items = [_snapped_scene(n, s, card) for s in range(b)]
    coords = torch.stack([c for c, _ in items])
    cluster = torch.stack([c for _, c in items])
    assert bool((torch.signbit(coords) & (coords == 0)).any())
    g = torch.Generator().manual_seed(n + b)
    valid = (torch.rand(b, n, generator=g) < 0.9).to(card)
    query = (cluster >= 0) & valid if queried else None
    d = boundary_distances_all(coords, cluster, valid, query)
    torch.cuda.synchronize()
    ref = boundary_distances_all_reference(coords, cluster, valid, query)
    assert torch.equal(d, ref), int((d != ref).sum())
    assert bool((ref == 0).any())


def test_boundary_distances_refuse_bad_inputs(card):
    coords, cluster, valid = _rollout_case(1, 100, 0.9, 3, 0, card)
    with pytest.raises(TypeError):
        boundary_distances_all(coords.double(), cluster, valid)
    with pytest.raises(TypeError):
        boundary_distances_all(coords, cluster.long(), valid)
    with pytest.raises(ValueError):
        boundary_distances_all(coords, cluster, valid.cpu())
    with pytest.raises(ValueError):
        boundary_distances_all(coords[:, :50], cluster, valid[:, :50])
    with pytest.raises(ValueError):  # every other row: not contiguous
        boundary_distances_all(coords[:, ::2], cluster[:, ::2],
                               valid[:, ::2])
    with pytest.raises(TypeError):
        boundary_distances_all(coords, cluster, valid, valid.int())
    with pytest.raises(ValueError):
        boundary_distances_all(coords, cluster, valid, valid.cpu())
    with pytest.raises(ValueError):
        boundary_distances_all(coords, cluster, valid,
                               pairs=torch.zeros(1, device=card))


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sharded_distance_call_is_the_one_process_rounds(card, n_sp):
    """Each rank's call (query = the error rows of its own rows, on the
    gathered columns) gives, on the kernel, the bits of the one-process
    round on those rows (sorted rows, as ``build_pyramid`` gives them)."""
    rng = np.random.default_rng(n_sp)
    n = 8192
    grid = np.stack(np.unravel_index(np.sort(rng.choice(40 ** 3, n,
                                                        replace=False)),
                                     (40, 40, 40)), 1)
    coords = torch.from_numpy((grid * 0.05).astype(np.float32)).to(card)
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(card)
    pred = torch.where(torch.from_numpy(rng.random(n) < 0.3).to(card),
                       torch.from_numpy(rng.integers(0, 4, n).astype(
                           np.int32)).to(card), labels)
    valid = torch.from_numpy(np.arange(n) < n - 300).to(card)
    err, compact, d, _ = error_clusters(pred[None], labels[None],
                                        coords[None], valid[None], 10)
    cluster = torch.where(err, compact, -1).to(torch.int32)[0]
    nl = n // n_sp
    for r in range(n_sp):
        own = torch.zeros(n, dtype=torch.bool, device=card)
        own[r * nl:(r + 1) * nl] = True
        got = boundary_distances_all(coords[None], cluster[None],
                                     valid[None],
                                     query=((cluster >= 0) & own)[None])
        rows = slice(r * nl, (r + 1) * nl)
        e = err[0, rows]
        assert torch.equal(got[0, rows][e], d[0, rows][e])
