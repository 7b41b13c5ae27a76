"""The boundary distance of the query rows only (``ops/boundary_dist.py``
with ``query``), its use by the device rollouts' error analysis
(``engine/device_eval.py::error_clusters``), and the plain twin of the
kernel's culling bound, on the CPU.

Tolerances: the query rows equal the all-rows plain version bit for bit
and the other rows are +inf; ``error_clusters`` equals the all-rows chain
bit for bit and the JAX package's within one ulp (XLA on the CPU contracts
the JAX function's sum into FMAs; ``tests/test_torch_device_eval.py``); the
bound is <= every pair's squared distance with no tolerance at all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from agile3d_torch.engine import device_eval as pdev
from agile3d_torch.ops.boundary_dist import (
    all_pairs,
    boundary_distances_all,
    boundary_distances_all_reference,
    box_lower_bound,
)
from agile3d_tpu.engine import device_eval as jdev

torch.set_num_threads(1)


def _items(seed, b=3, n=400, n_cl=4, valid_frac=0.85, query_frac=0.3):
    rng = np.random.default_rng(seed)
    coords = (rng.random((b, n, 3)) * 4 - 2).astype(np.float32)
    cluster = rng.integers(-1, n_cl, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < valid_frac
    query = rng.random((b, n)) < query_frac
    return [torch.from_numpy(a) for a in (coords, cluster, valid, query)]


@pytest.mark.parametrize("case", ["mixed", "empty_item", "invalid_queries",
                                  "all_rows_queried", "one_cluster"])
def test_query_rows_equal_the_all_rows_version(case):
    coords, cluster, valid, query = _items(11)
    if case == "empty_item":
        query[1] = False
    elif case == "invalid_queries":
        query = query | ~valid          # rows without a key of their own
    elif case == "all_rows_queried":
        query[:] = True
    elif case == "one_cluster":
        cluster[:] = 1
    whole = boundary_distances_all_reference(coords, cluster, valid)
    got = boundary_distances_all_reference(coords, cluster, valid, query)
    assert torch.equal(got[query], whole[query])
    assert torch.isinf(got[~query]).all() and (got[~query] > 0).all()
    if case == "all_rows_queried":
        assert torch.equal(got, whole)
    if case == "one_cluster":
        assert torch.isinf(got).all()
    # the wrapper takes the plain version for CPU tensors, uncounted
    launches = boundary_distances_all.launches
    assert torch.equal(boundary_distances_all(coords, cluster, valid, query),
                       got)
    assert boundary_distances_all.launches == launches
    with pytest.raises(ValueError, match="card only"):
        boundary_distances_all(coords, cluster, valid, query,
                               pairs=torch.zeros(1, dtype=torch.int64))


def test_all_pairs_counts_query_rows_times_valid_keys():
    coords, cluster, valid, query = _items(3)
    want = sum(int(query[i].sum()) * int(valid[i].sum()) for i in range(3))
    assert all_pairs(valid, query) == want
    assert all_pairs(valid) == 400 * int(valid.sum())


def _all_rows_chain(pred, labels, coords, valid, max_label):
    """error_clusters as it was before the query mask: every row's
    distance, then -inf off the error rows."""
    k = max_label + 1
    err = valid & (pred != labels)
    compact = labels * k + pred
    cluster = torch.where(err, compact, -1).to(torch.int32)
    d = boundary_distances_all_reference(coords, cluster, valid)
    d = torch.where(err, d, torch.full((), float("-inf")))
    seg = torch.where(err, compact, k * k).long()
    sizes = torch.full((pred.shape[0], k * k + 1), float("-inf")
                       ).scatter_reduce(1, seg, d, "amax")[:, :k * k]
    sizes = torch.where(torch.isfinite(sizes), sizes,
                        torch.full((), float("-inf")))
    return err, compact, d, sizes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_clusters_match_the_all_rows_chain_and_jax(seed):
    rng = np.random.default_rng(seed)
    b, n, max_label = 2, 512, 4
    coords = (rng.random((b, n, 3)) * 4).astype(np.float32)
    labels = rng.integers(0, max_label + 1, (b, n)).astype(np.int32)
    pred = labels.copy()
    flip = rng.random((b, n)) < 0.25
    pred[flip] = rng.integers(0, max_label + 1, int(flip.sum()))
    valid = np.ones((b, n), bool)
    valid[:, -37:] = False
    if seed == 2:
        pred[1] = labels[1]             # an item with no error row
    t = [torch.from_numpy(a) for a in (pred, labels, coords, valid)]
    got = pdev.error_clusters(*t, max_label)
    want = _all_rows_chain(*t, max_label)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    err, compact, d, sizes = got
    assert torch.isneginf(d[~err]).all()
    if seed == 2:
        assert torch.isneginf(sizes[1]).all()
    k = max_label + 1
    for i in range(b):
        jd = jdev._boundary_distances_all(
            jnp.asarray(coords[i]),
            jnp.asarray(np.where(err[i].numpy(), compact[i].numpy(), -1)),
            jnp.asarray(valid[i]))
        jd = np.where(err[i].numpy(), np.asarray(jd), -np.inf)
        js = np.asarray(jax.ops.segment_max(
            jnp.asarray(jd), jnp.asarray(np.where(err[i].numpy(),
                                                  compact[i].numpy(), k * k)),
            num_segments=k * k + 1))[:k * k]
        js = np.where(np.isfinite(js), js, -np.inf).astype(np.float32)
        np.testing.assert_array_equal(np.isneginf(d[i].numpy()),
                                      np.isneginf(jd))
        fin = np.isfinite(jd)
        np.testing.assert_array_max_ulp(d[i].numpy()[fin],
                                        jd[fin].astype(np.float32), maxulp=1)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(sizes[i].numpy()), fin)
        np.testing.assert_array_max_ulp(sizes[i].numpy()[fin], js[fin],
                                        maxulp=1)


# adversarial float32 coordinates: signed zeros, ties, both signs, tiny and
# large magnitudes, values one ulp apart
_SPECIAL = [0.0, -0.0, 1.0, -1.0, 1.0000001, 0.99999994, 1e-30, -1e-30,
            3.4e18, -3.4e18, 0.1, -0.1, 1e-7, 2.5, -2.5]
_coord = st.one_of(st.sampled_from(_SPECIAL),
                   st.floats(-1e6, 1e6, width=32, allow_nan=False,
                             allow_infinity=False))
_points = st.lists(st.tuples(_coord, _coord, _coord), min_size=1,
                   max_size=6)


def _pair_d2(q, k):
    """Every pair's squared distance, rounded as the kernel and the plain
    version round it: ((dx dx + dy dy) + dz dz) in float32."""
    diff = q[:, None, :] - k[None, :, :]
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


@settings(max_examples=400, deadline=None, database=None)
@given(_points, _points, st.sampled_from(["apart", "touching", "equal",
                                          "shifted"]))
def test_box_lower_bound_never_exceeds_a_pair(qpts, kpts, how):
    q = torch.tensor(qpts, dtype=torch.float32)
    k = torch.tensor(kpts, dtype=torch.float32)
    if how == "touching":               # k's box starts where q's ends
        k = k - k.amin(0) + q.amax(0)
    elif how == "equal":
        k = q.clone()
    elif how == "shifted":              # one ulp up on every axis
        k = torch.nextafter(q, torch.full_like(q, float("inf")))
    d2 = _pair_d2(q, k)
    lb = box_lower_bound(q.amin(0), q.amax(0), k.amin(0), k.amax(0))
    assert lb.dtype == torch.float32
    if torch.isnan(d2).any():           # inf - inf after an overflow
        return
    assert bool((lb <= d2).all()), (float(lb), float(d2.min()))
    if how == "equal":
        assert float(lb) == 0.0


def test_box_lower_bound_is_tight_on_one_axis():
    """Boxes apart on x only: the bound is the computed x gap squared,
    the same from either side, and below every pair."""
    q = torch.tensor([[-3.0, -0.0, 1.0], [-2.5, 0.5, 2.0]])
    k = torch.tensor([[1.0, 0.0, 1.5], [4.0, 0.25, 1.75]])
    lb = box_lower_bound(q.amin(0), q.amax(0), k.amin(0), k.amax(0))
    assert float(lb) == 3.5 * 3.5
    assert float(_pair_d2(q, k).min()) >= float(lb)
    assert float(box_lower_bound(k.amin(0), k.amax(0), q.amin(0),
                                 q.amax(0))) == float(lb)
