"""The port's device eval rollout (``agile3d_torch/engine/device_eval.py``)
and the plain version of its boundary-distance kernel against the JAX
package's ``engine/device_eval.py`` on the CPU, and the device rollout's
CSV rows against the port's host loop.

Tolerances: the plain distances equal a numpy evaluation of the same
float32 operations bit for bit, and the JAX function's within one ulp: XLA
on the CPU contracts its per-axis sum into FMAs (fma(dz, dz, fma(dx, dx,
dy dy)), checked below), while the port rounds every operation as written,
as its kernel does. The click override and the clicks picked are exact;
the rows' ID, scene, object and click columns are exact and the
IoUs within 1e-5, as ``tests/test_device_eval.py`` holds the JAX paths."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.data.datasets import InterMultiObjDataset as PortDataset
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.data.synthetic import write_benchmark as port_write_benchmark
from agile3d_torch.engine import device_eval as pdev
from agile3d_torch.engine import clicks as pclicks
from agile3d_torch.engine import eval as peval
from agile3d_torch.engine.clicks import click_override_device
from agile3d_torch.ops import boundary_dist as bd
from agile3d_torch.ops.boundary_dist import (
    boundary_distances_all,
    boundary_distances_all_reference,
    distance_work,
)
from agile3d_tpu.engine import clicks as jclicks
from agile3d_tpu.engine import device_eval as jdev
from tests.test_torch_model import SMALL, port_model, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)


def _cloud(seed, n=1024, n_cl=4, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    coords = (rng.random((n, 3)) * 4).astype(np.float32)
    cluster = rng.integers(-1, n_cl, n).astype(np.int32)
    valid = rng.random(n) < valid_frac
    return coords, cluster, valid


def _numpy_distances(coords, cluster, valid, fma=False):
    """The function in numpy, every float32 operation rounded as written,
    or (``fma``) with XLA's CPU contraction fma(dz, dz, fma(dx, dx, dy
    dy)), each fma rounded once (exact in float64 for float32 inputs)."""
    diff = [coords[:, ax][:, None] - coords[:, ax][None, :] for ax in range(3)]
    if fma:
        f64, f32 = np.float64, np.float32
        sq = lambda a: a.astype(f64) ** 2
        d2 = ((sq(diff[0]) + (diff[1] * diff[1]).astype(f64)).astype(f32)
              .astype(f64) + sq(diff[2])).astype(f32)
    else:
        d2 = (diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]
    excl = (cluster[:, None] == cluster[None, :]) | ~valid[None, :]
    return np.sqrt(np.maximum(np.where(excl, np.float32(np.inf), d2)
                              .min(axis=1), np.float32(0)))


def test_jax_on_the_cpu_contracts_the_sum_into_fmas():
    """Why the JAX comparison allows one ulp: XLA's CPU result is the FMA
    form exactly, and differs from the rounded-as-written form."""
    coords, cluster, valid = _cloud(3)
    want = np.asarray(jdev._boundary_distances_all(
        jnp.asarray(coords), jnp.asarray(cluster), jnp.asarray(valid)))
    np.testing.assert_array_equal(
        want, _numpy_distances(coords, cluster, valid, fma=True))
    assert (want != _numpy_distances(coords, cluster, valid)).any()


@pytest.mark.parametrize("case", ["mixed", "padded", "all_invalid",
                                  "one_cluster"])
def test_boundary_distances_plain_matches_jax(case):
    coords, cluster, valid = _cloud(3)
    if case == "padded":
        valid[700:] = False
        coords[700:] = 0.0
    elif case == "all_invalid":
        valid[:] = False
    elif case == "one_cluster":
        cluster[:] = 2
    want = np.asarray(jdev._boundary_distances_all(
        jnp.asarray(coords), jnp.asarray(cluster), jnp.asarray(valid)))
    got = boundary_distances_all_reference(
        torch.from_numpy(coords)[None], torch.from_numpy(cluster)[None],
        torch.from_numpy(valid)[None])[0].numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(got, _numpy_distances(coords, cluster,
                                                        valid))
    if case in ("all_invalid", "one_cluster"):
        assert np.isinf(got).all()
    else:
        assert np.isfinite(got).mean() > 0.5


def test_boundary_distances_batch_and_chunks():
    """A batch is its items one by one, and the chunking of query rows does
    not change a bit; the wrapper takes the plain version on the CPU
    without counting a launch."""
    items = [_cloud(s, n=300, n_cl=3) for s in (1, 2)]
    coords, cluster, valid = (torch.from_numpy(np.stack(a))
                              for a in zip(*items))
    whole = boundary_distances_all_reference(coords, cluster, valid)
    for i in range(2):
        one = boundary_distances_all_reference(coords[i:i + 1],
                                               cluster[i:i + 1],
                                               valid[i:i + 1])
        assert torch.equal(one[0], whole[i])
    old = bd._CHUNK_ELEMS
    try:
        bd._CHUNK_ELEMS = 7 * 300  # 7-row chunks, the last one ragged
        assert torch.equal(
            boundary_distances_all_reference(coords, cluster, valid), whole)
    finally:
        bd._CHUNK_ELEMS = old
    launches = boundary_distances_all.launches
    assert torch.equal(boundary_distances_all(coords, cluster, valid), whole)
    assert boundary_distances_all.launches == launches


def test_distance_kernel_sizes_and_work():
    """Mirrors of csrc/boundary_dist.cu (read from the source): 32-record
    key tiles, 4 warps a CTA of 32 query rows each, 1,024-row scan chunks;
    the least work counts one pair (8 operations) per query row and each
    input byte once, and the all-pairs count is query rows times valid keys
    per item."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(bd.__file__), os.pardir, "csrc",
                            "boundary_dist.cu")).read()
    num = lambda pat: int(re.search(pat, src).group(1))
    assert bd.TILE == num(r"constexpr int TILE = (\d+);") == 32
    assert bd.WARPS == num(r"constexpr int WARPS = (\d+);")
    assert bd.SCAN_CHUNK == (num(r"constexpr int SCAN_THREADS = (\d+);")
                             * num(r"constexpr int SCAN_RPT = (\d+);"))
    assert num(r"constexpr int QGROUP = (\d+);") == 32
    cluster = torch.tensor([[-1, -1, 3, 3, 5], [0, 0, 0, 0, 0]],
                           dtype=torch.int32)
    valid = torch.tensor([[True, True, True, False, True],
                          [True, True, False, False, False]])
    query = torch.tensor([[False, False, True, False, True],
                          [True, False, False, False, False]])
    ops, nbytes = distance_work(cluster, valid)
    assert ops == 8.0 * 10 and nbytes == 2 * 5 * 21.0
    ops, nbytes = distance_work(cluster, valid, query)
    assert ops == 8.0 * 3 and nbytes == 2 * 5 * 22.0
    assert bd.all_pairs(valid) == 5 * 4 + 5 * 2
    assert bd.all_pairs(valid, query) == 2 * 4 + 1 * 2
    coords, cl, ok = _cloud(5, n=200)
    t = lambda a: torch.from_numpy(a)[None]
    d = boundary_distances_all_reference(t(coords), t(cl), t(ok))[0]
    assert np.isfinite(d.numpy()).all()


@pytest.mark.parametrize("batched", [False, True])
def test_click_override_matches_jax(batched):
    rng = np.random.default_rng(7)
    n, mc = 50, 12
    pred = rng.integers(0, 5, (3, n) if batched else n).astype(np.int32)
    vox = rng.integers(0, n, pred.shape[:-1] + (mc,)).astype(np.int32)
    obj = rng.integers(0, 6, vox.shape).astype(np.int32)
    vox[..., 3] = vox[..., 1]   # a shared voxel: the larger id wins
    obj[..., 3] = 5
    obj[..., 1] = 2
    vox[..., -4:] = -1          # unused slots
    obj[..., -4:] = 4
    want = np.asarray(jclicks.click_override_device(
        jnp.asarray(pred), jnp.asarray(vox), jnp.asarray(obj)))
    got = click_override_device(*(torch.from_numpy(a)
                                  for a in (pred, vox, obj))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., vox[..., 1]] if not batched
            else got[np.arange(3), vox[:, 1]]).min() == 5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simulate_click_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 512
    coords = (rng.random((n, 3)) * 4).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    pred = labels.copy()
    flip = rng.random(n) < 0.2
    pred[flip] = rng.integers(0, 4, flip.sum())
    valid = np.ones(n, bool)
    valid[-40:] = False
    want = jdev.simulate_click_device(
        jnp.asarray(pred), jnp.asarray(labels), jnp.asarray(coords),
        jnp.asarray(valid))
    got = pdev.simulate_click_device(
        *(torch.from_numpy(a) for a in (pred, labels, coords, valid)))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert bool(got[2])


def test_simulate_click_without_errors():
    n = 512
    labels = np.arange(n, dtype=np.int32) % 3
    t = torch.from_numpy(labels)
    want = jdev.simulate_click_device(
        jnp.asarray(labels), jnp.asarray(labels), jnp.zeros((n, 3)),
        jnp.ones(n, bool))
    got = pdev.simulate_click_device(t, t, torch.zeros(n, 3),
                                     torch.ones(n, dtype=torch.bool))
    assert not bool(got[2]) and not bool(want[2])
    assert [int(v) for v in got[:2]] == [int(v) for v in want[:2]]


def _round0_scene(case, seed, n=700):
    """Round 0's inputs: coords [N, 3] float32, labels [N] (-1 on pad
    rows, which follow the n valid ones). Objects 1..5 are balls in a
    background 0; "single" binarises them; "pad" adds pad rows (at the
    origin, nearer than any scene row) for the kernel's valid mask to
    exclude; "ties" puts the points on an integer grid with duplicates,
    so clusters' largest distances are attained by several rows;
    "one_object" labels every row 1, so no row of another cluster exists
    and every distance is +inf."""
    rng = np.random.default_rng(seed)
    if case == "ties":
        coords = rng.integers(0, 8, (n, 3)).astype(np.float32)
    else:
        coords = (rng.random((n, 3)) * 6).astype(np.float32)
    labels = np.zeros(n, np.int32)
    for o, c in enumerate(rng.random((5, 3)) * 6, start=1):
        labels[np.linalg.norm(coords - c, axis=1) < 1.5] = o
    if case == "single":
        labels = (labels == labels.max()).astype(np.int32)
    if case == "one_object":
        labels[:] = 1
    if case == "pad":
        coords = np.concatenate([coords, np.zeros((40, 3), np.float32)])
        labels = np.concatenate([labels, np.full(40, -1, np.int32)])
    return coords, labels


@pytest.mark.parametrize("case,seed", [
    ("multi", 0), ("multi", 1), ("multi", 2), ("single", 0), ("single", 1),
    ("pad", 3), ("ties", 4), ("one_object", 5)])
def test_round0_clicks_on_the_kernel_are_the_host_loops(case, seed):
    """Round 0 of the device eval (its distances through the kernel's
    wrapper, over the scene's padded rows) places the clicks that
    ``simulate_clicks`` places on the plain distance with the same
    ``random.Random`` seed: the same rows, objects and shuffled order;
    the first row wins a tie, and an all-+inf cluster still clicks."""
    coords, labels = _round0_scene(case, seed)
    n = int((labels >= 0).sum())
    num_obj = int((np.unique(labels[:n]) > 0).sum())
    want = pclicks.simulate_clicks(
        np.zeros(n, np.int32), labels[:n], coords[:n], num_obj=num_obj,
        training=False, current_num_clicks=0, rng=random.Random(seed),
        device="cpu")
    lab = torch.from_numpy(labels)
    got = pdev.round0_clicks(torch.from_numpy(coords), lab >= 0, lab,
                             labels[:n], num_obj=num_obj,
                             rng=random.Random(seed))
    assert len(want.vox) == (1 if case in ("single", "one_object")
                             else num_obj) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    err = np.nonzero(labels[:n])[0]
    d = pclicks.boundary_distances(
        torch.from_numpy(coords[:n]), torch.from_numpy(labels[:n]),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(err)).numpy()
    if case == "ties":  # a picked cluster's largest distance, twice or more
        assert any((d[labels[err] == labels[v]] == d[err == v].max()).sum()
                   > 1 for v in want.vox)
    if case == "one_object":
        assert np.isinf(d).all() and list(want.vox) == [0]


def test_round0_without_objects_places_no_click():
    coords, labels = _round0_scene("multi", 0, n=50)
    labels[:] = 0
    lab = torch.from_numpy(labels)
    assert pdev.round0_clicks(torch.from_numpy(coords), lab >= 0, lab,
                              labels, num_obj=0,
                              rng=random.Random(0)) is None


MAX_NUM_CLICKS = 3
ROLLOUT_SEED = 13


@pytest.fixture(scope="module")
def port_rollouts(tmp_path_factory):
    """``tests/test_torch_eval.py``'s tiny scene and weights through the
    port's host loop and its device rollout."""
    root = tmp_path_factory.mktemp("device_eval")
    scans, val_list = port_write_benchmark(str(root), num_scenes=1,
                                           num_obj=3, seed=11, n_points=1500)
    sd, _, _, _ = randomized_weights(SMALL, 42, np.random.default_rng(0))
    cfg = PortConfig(model=port_model_config(SMALL))
    batch = port_collate([PortDataset(scans, val_list, 0.05)[0]], cfg.buckets)
    engine = peval.InteractiveEngine(cfg, port_model(SMALL, sd), device="cpu")
    host = peval.evaluate_scene(engine, batch, instance_id=0,
                                rng=random.Random(ROLLOUT_SEED),
                                max_num_clicks=MAX_NUM_CLICKS)
    device = pdev.evaluate_scene_device(engine, batch, instance_id=0,
                                        rng=random.Random(ROLLOUT_SEED),
                                        max_num_clicks=MAX_NUM_CLICKS)
    return dict(host=host, device=device, engine=engine, batch=batch,
                root=root, scans=scans, val_list=val_list)


def test_device_rollout_rows_match_host_loop(port_rollouts):
    host = [r.split(" ") for r in port_rollouts["host"]]
    dev = [r.split(" ") for r in port_rollouts["device"]]
    assert len(dev) == len(host) == 8  # rounds at 0, 3, 4, ..., 9 clicks
    assert [d[:4] for d in dev] == [h[:4] for h in host]
    np.testing.assert_allclose([float(d[4]) for d in dev],
                               [float(h[4]) for h in host], rtol=0, atol=1e-5)


def test_device_rollout_takes_the_kernel_in_round_0(port_rollouts,
                                                    monkeypatch):
    """The device eval calls the distance kernel's wrapper once in round 0
    and once a round after it, and the plain distance never; the host loop
    keeps the plain distance in every round and never calls the wrapper."""
    calls = {"kernel": 0, "plain": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(pdev, "boundary_distances_all",
                        counted("kernel", pdev.boundary_distances_all))
    monkeypatch.setattr(pclicks, "boundary_distances",
                        counted("plain", pclicks.boundary_distances))
    engine, batch = port_rollouts["engine"], port_rollouts["batch"]
    seen = {}
    for name, fn in (("device", pdev.evaluate_scene_device),
                     ("host", peval.evaluate_scene)):
        calls.update(kernel=0, plain=0)
        rows = fn(engine, batch, instance_id=0,
                  rng=random.Random(ROLLOUT_SEED),
                  max_num_clicks=MAX_NUM_CLICKS)
        seen[name] = dict(calls, rows=rows)
    assert seen["device"]["rows"] == port_rollouts["device"]
    rounds = len(seen["device"]["rows"]) - 1
    assert (seen["device"]["kernel"], seen["device"]["plain"]) == \
        (rounds + 1, 0)
    assert (seen["host"]["kernel"], seen["host"]["plain"]) == \
        (0, len(seen["host"]["rows"]))


def test_device_rollout_sees_the_host_loops_click_buckets(port_rollouts,
                                                          monkeypatch):
    """With a bucket ladder that the tiny budget crosses twice, the device
    rounds hand the decoder the click table cut to the host loop's bucket
    in every round (the attention then reduces over as many clicks in both,
    rounding alike), and the rows still agree."""
    engine, batch = port_rollouts["engine"], port_rollouts["batch"]
    monkeypatch.setattr(engine, "CLICK_BUCKETS", (4, 8, 16, 32))
    widths = []
    real = engine.model.forward_mask

    def spy(scene, clicks, num_obj):
        widths.append(clicks.vox.shape[1])
        return real(scene, clicks, num_obj)

    monkeypatch.setattr(engine.model, "forward_mask", spy)
    rows = {}
    for name, fn in (("host", peval.evaluate_scene),
                     ("device", pdev.evaluate_scene_device)):
        widths.clear()
        rows[name] = [r.split(" ") for r in fn(
            engine, batch, instance_id=0, rng=random.Random(ROLLOUT_SEED),
            max_num_clicks=MAX_NUM_CLICKS)]
        rows[name + "_widths"] = list(widths)
    # 3 clicks after round 0, one more a round: 3..9 clicks seen
    assert rows["host_widths"] == [4, 4, 8, 8, 8, 8, 16]
    assert rows["device_widths"] == rows["host_widths"]
    assert [d[:4] for d in rows["device"]] == [h[:4] for h in rows["host"]]
    np.testing.assert_allclose([float(d[4]) for d in rows["device"]],
                               [float(h[4]) for h in rows["host"]],
                               rtol=0, atol=1e-5)


def test_device_rollout_holds_the_converged_round(port_rollouts,
                                                 monkeypatch):
    """A decoder that is right everywhere in round 2 and wrong everywhere
    after: the host loop stops calling it once nothing is left to correct;
    the device rounds go on calling it but add no click and repeat round
    2's IoU, so the rows agree."""
    engine, batch = port_rollouts["engine"], port_rollouts["batch"]
    real = engine.model.forward_mask
    calls = []

    def decoder(scene, clicks, num_obj):
        calls.append(1)
        out = real(scene, clicks, num_obj)
        masks = out["pred_masks"]
        if len(calls) >= 2:
            n, k = masks.shape[1], masks.shape[2]
            target = np.zeros(n, np.int64)
            m = min(n, batch.labels.shape[1])
            target[:m] = np.maximum(batch.labels[0, :m], 0)
            right = torch.nn.functional.one_hot(torch.from_numpy(target), k)
            wrong = torch.nn.functional.one_hot(
                torch.from_numpy((target + 1) % k), k)
            masks = (right if len(calls) == 2 else wrong)[None].to(masks)
        return {**out, "pred_masks": masks}

    monkeypatch.setattr(engine.model, "forward_mask", decoder)
    rows, n_calls = {}, {}
    for name, fn in (("host", peval.evaluate_scene),
                     ("device", pdev.evaluate_scene_device)):
        calls.clear()
        rows[name] = [r.split(" ") for r in fn(
            engine, batch, instance_id=0, rng=random.Random(ROLLOUT_SEED),
            max_num_clicks=MAX_NUM_CLICKS)]
        n_calls[name] = len(calls)
    assert n_calls == {"host": 2, "device": 7}
    ious = [float(h[4]) for h in rows["host"]]
    assert ious[2:] == [ious[2]] * 6 and ious[2] > ious[1]
    assert [d[:4] for d in rows["device"]] == [h[:4] for h in rows["host"]]
    np.testing.assert_allclose([float(d[4]) for d in rows["device"]], ious,
                               rtol=0, atol=1e-5)


def test_evaluate_dataset_defaults_to_device_rollout(port_rollouts,
                                                     monkeypatch):
    """evaluate_dataset takes the device rollout unless asked for the host
    loop, and both write the same rows."""
    calls = []
    real = peval.evaluate_scene_device
    monkeypatch.setattr(peval, "evaluate_scene_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ds = PortDataset(port_rollouts["scans"], port_rollouts["val_list"], 0.05)
    root = port_rollouts["root"]
    out = {}
    for name, flag in (("device", True), ("host", False)):
        path = str(root / f"{name}.csv")
        peval.evaluate_dataset(port_rollouts["engine"], ds, path,
                               max_num_clicks=MAX_NUM_CLICKS,
                               seed=ROLLOUT_SEED, log=lambda m: None,
                               device_rollout=flag)
        out[name] = open(path).read().split("\n")
    assert calls == [1]
    assert out["device"][0].split(" ")[:4] == out["host"][0].split(" ")[:4]
    assert [r.split(" ")[:4] for r in out["device"]] == \
        [r.split(" ")[:4] for r in out["host"]]


def test_eval_cli_takes_host_rollout_flag():
    from agile3d_torch import eval_multi_obj

    p = eval_multi_obj.get_args_parser()
    base = ["--scan_folder", "s", "--val_list", "v"]
    assert not p.parse_args(base).host_rollout
    assert p.parse_args(base + ["--host_rollout"]).host_rollout
