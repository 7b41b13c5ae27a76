"""The port's data-parallel step (``agile3d_torch/parallel/train.py``) on a
spawned 2-rank ``gloo`` group, the counterparts of the JAX package's
``tests/test_dp_train.py`` at its configuration (a backbone of 8 channels,
the decoder at 32, scenes of 600 points, the click table of
``_fixed_clicks``):

  * two identical groups equal the one-process step on that group (loss
    and mIoU within 1e-5, parameters within 5e-6 / 1e-4, the JAX test's
    bounds), and both ranks hold the same parameters after the step;
  * a weight-0 tail rank changes nothing, whatever its content;
  * a short trajectory (4 steps; the JAX test takes 22) re-synced at each
    step: from the same state, the dp step equals the one-process step;
  * two different groups against a one-process reference made here
    without the dp code: each group's loss scaled by its weight over the
    weights' sum, the gradients accumulated, one optimizer step, the
    BatchNorm statistics averaged by weight, mIoU weighted by row;
  * (``slow``: JAX's 2-device compile takes ~35 s on the CPU) one step on
    two different groups against JAX's ``make_dp_train_step`` on a 2-device
    mesh, at the tolerances that ``tests/test_torch_train.py`` holds the
    one-process step to against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.config import TrainConfig as PortTrainConfig
from agile3d_torch.data.datasets import SceneSample as PortSample
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.engine.train import (
    _per_sample_iou,
    make_optimizer,
    make_train_step,
    supervised_forward,
)
from agile3d_torch.parallel.mesh import spawn
from agile3d_torch.parallel.train import (
    collate_sharded,
    prepare_dp_step,
    rank_seed,
)
from tests import torch_parallel_ranks as ranks
from tests.test_dp_train import CFG, _dataset, _fixed_clicks
from tests.test_torch_model import randomized_weights
from tests.test_torch_weights import port_model_config

PCFG = PortConfig(model=port_model_config(CFG.model),
                  train=PortTrainConfig(batch_size=1, lr=2e-3),
                  buckets=CFG.buckets)
STEPS = 4


def _port(samples):
    return [PortSample(**s._asdict()) for s in samples]


def _clicks(d, nv):
    return [tuple(np.asarray(a)[r] for a in _fixed_clicks(d, 1, nv))
            for r in range(d)]


def _traj_clicks(t, nv):
    row = [(t * 7 + 1) % nv, (t * 13 + 3) % nv, (t * 3 + 9) % nv, -1]
    return (np.asarray([row], np.int32), np.asarray([[1, 2, 1, 0]], np.int32),
            np.asarray([[0, 1, 2, 0]], np.int32))


@pytest.fixture(scope="module")
def runs():
    sd, params, buffers, bn_state = randomized_weights(
        CFG.model, 2, np.random.default_rng(2))
    ds = _port(_dataset(n_scenes=4, seed=11))
    traj_ds = _port(_dataset(n_scenes=5, seed=21))
    clicks = _clicks(2, 50)
    cases = {"identical": ([[ds[0]], [ds[0]]], [1, 1], clicks),
             "tail_a": ([[ds[1]], [ds[1]]], [1, 0], clicks),
             "tail_b": ([[ds[1]], [ds[3]]], [1, 0], clicks),
             "pair": ([[ds[0]], [ds[2]]], [1, 1], clicks)}
    samples = [traj_ds[t % len(traj_ds)] for t in range(STEPS)]
    rows = [_traj_clicks(t, len(s.vox_coords)) for t, s in enumerate(samples)]
    got = spawn(ranks.dp_cases, 2, PCFG, sd, cases, (samples, rows),
                device="cpu")
    return dict(got=got, sd=sd, ds=ds, clicks=clicks, params=params,
                buffers=buffers, bn_state=bn_state)


def _one_process_step(sd, sample, clicks):
    model = ranks.model_from(PCFG.model, sd)
    opt, _ = make_optimizer(model, PCFG, 1)
    out = make_train_step(PCFG, model, opt)(*ranks._step_inputs(
        port_collate([sample], PCFG.buckets), clicks))
    return ranks._result(out), ranks._state(model)


def _same_states(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


def test_identical_groups_equal_the_one_process_step(runs):
    got = runs["got"]
    one, state = _one_process_step(runs["sd"], runs["ds"][0],
                                   runs["clicks"][0])
    for g in got:
        dp = g["identical"]
        assert abs(dp["loss"] - one["loss"]) < 1e-5
        assert abs(dp["miou"] - one["miou"]) < 1e-5
        np.testing.assert_allclose(dp["gnorm"], one["gnorm"], rtol=1e-5)
        _same_states(dp["state"], state, atol=5e-6, rtol=1e-4)
    # both ranks hold the same weights and statistics, bit for bit
    _same_states(got[0]["identical"]["state"], got[1]["identical"]["state"],
                 atol=0, rtol=0)


def test_weight_zero_tail_ignores_its_content(runs):
    a, b = runs["got"][0]["tail_a"], runs["got"][0]["tail_b"]
    for key in ("loss", "gnorm", "miou"):
        assert a[key] == b[key], key
    _same_states(a["state"], b["state"], atol=0, rtol=0)
    one, state = _one_process_step(runs["sd"], runs["ds"][1],
                                   runs["clicks"][0])
    assert abs(a["loss"] - one["loss"]) < 1e-5
    _same_states(a["state"], state, atol=5e-6, rtol=1e-4)


def test_trajectory_resynced_each_step_matches(runs):
    traj = runs["got"][0]["trajectory"]
    assert len(traj) == STEPS
    for t, step in enumerate(traj):
        np.testing.assert_allclose(step["dp"]["loss"], step["one"]["loss"],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"loss at step {t}")
        _same_states(step["dp_state"], step["one_state"], atol=2e-5,
                     rtol=1e-4)
    assert min(s["dp"]["loss"] for s in traj[1:]) < traj[0]["dp"]["loss"]


def _weighted_sum_step(sd, samples, clicks, shard_w):
    """The dp step's definition in one process: the groups' forwards one
    after another, each backward on its loss times w / sum(w), one
    clipped AdamW step on the summed gradient; BatchNorm's new statistics
    and the reported numbers are weighted means over the groups."""
    import torch

    from agile3d_torch.models.backbone import commit_bn_stats
    from agile3d_torch.models.criterion import (
        loss_weight_dict,
        model_num_aux_rounds,
    )

    model = ranks.model_from(PCFG.model, sd)
    opt, _ = make_optimizer(model, PCFG, 1)
    wd = loss_weight_dict(PCFG.loss,
                          num_aux_rounds=model_num_aux_rounds(PCFG.model))
    wsum = float(sum(shard_w))
    opt.zero_grad()
    loss = miou_num = miou_den = 0.0
    stats = {}
    for sample, c, w in zip(samples, clicks, shard_w):
        device_batch, cs, labels, num_obj = ranks._step_inputs(
            port_collate([sample], PCFG.buckets), c)
        bn = {}
        with torch.enable_grad():
            out, target, vox_valid, _, tot = supervised_forward(
                PCFG, model, wd, device_batch, cs, labels, num_obj, None, bn)
            (tot * (w / wsum)).backward()
        loss += float(tot.detach()) * w / wsum
        for s, (mean, var) in bn.items():
            m0, v0 = stats.get(s, (0.0, 0.0))
            stats[s] = (m0 + mean * (w / wsum), v0 + var * (w / wsum))
        with torch.no_grad():
            iou = _per_sample_iou(out["pred_masks"].argmax(-1), target,
                                  vox_valid, num_obj,
                                  PCFG.model.max_fg_objects)
            row_w = w * (num_obj > 0).float()
            miou_num += float((row_w * iou).sum())
            miou_den += float(row_w.sum())
    gnorm = float(opt.step())
    commit_bn_stats(stats)
    return ({"loss": loss, "gnorm": gnorm,
             "miou": miou_num / max(miou_den, 1e-8)}, ranks._state(model))


def test_pair_equals_the_weighted_sum_of_one_process_gradients(runs):
    """Two different groups: what the cross-rank reductions compute (the
    loss scaling, the gradient sum, the averaged statistics, the weighted
    mIoU), held against the same sums taken in one process."""
    one, state = _weighted_sum_step(runs["sd"], [runs["ds"][0],
                                                 runs["ds"][2]],
                                    runs["clicks"], [1.0, 1.0])
    for g in runs["got"]:
        dp = g["pair"]
        assert abs(dp["loss"] - one["loss"]) < 1e-5
        assert abs(dp["miou"] - one["miou"]) < 1e-5
        np.testing.assert_allclose(dp["gnorm"], one["gnorm"], rtol=1e-5)
        _same_states(dp["state"], state, atol=5e-6, rtol=1e-4)
    # the two groups differ, so the pair is not either group's step
    alone, _ = _one_process_step(runs["sd"], runs["ds"][0],
                                 runs["clicks"][0])
    assert abs(alone["loss"] - one["loss"]) > 1e-4
    _same_states(runs["got"][0]["pair"]["state"],
                 runs["got"][1]["pair"]["state"], atol=0, rtol=0)


def test_dp_assembly_is_per_rank_and_seeded():
    """Each rank collates its own group; a rank past the step's groups
    takes group 0 again with weight 0; the subsets and generators are
    drawn from the step's seed, the same for every depth and call."""
    ds = _port(_dataset(n_scenes=3, seed=5))
    cfg = PCFG
    b0, l0, n0, w = prepare_dp_step(ds, [0, 1, 2], 4, 1, cfg, 7, 0)
    b3, l3, n3, w3 = prepare_dp_step(ds, [0, 1, 2], 4, 1, cfg, 7, 3)
    assert list(w) == list(w3) == [1, 1, 1, 0]
    np.testing.assert_array_equal(l0, l3)     # rank 3 repeats group 0
    np.testing.assert_array_equal(n0, n3)
    again = prepare_dp_step(ds, [0, 1, 2], 4, 1, cfg, 7, 0)
    np.testing.assert_array_equal(again[1], l0)
    b1, l1, _, _ = prepare_dp_step(ds, [0, 1, 2], 4, 1, cfg, 7, 1)
    assert b1.scene_names == [ds[1].scene_name]
    batch, g, weight = collate_sharded(ds, [[2], [0]], 1, cfg.buckets)
    assert (g, weight) == (1, 1.0) and batch.scene_names == [ds[0].scene_name]
    assert rank_seed(5, 0) != rank_seed(5, 1) == rank_seed(5, 1)


@pytest.mark.slow
def test_pair_matches_jax_dp_step(runs):
    from agile3d_tpu.engine.train import make_optimizer as jax_optimizer
    from agile3d_tpu.parallel import make_mesh
    from agile3d_tpu.parallel.train import collate_sharded as jax_collate
    from agile3d_tpu.parallel.train import make_dp_train_step
    from agile3d_tpu.utils.ckpt import export_torch_state_dict

    ds = _dataset(n_scenes=4, seed=11)
    tx, _ = jax_optimizer(CFG, steps_per_epoch=1)
    params = runs["params"]
    step, shard_fn, _ = make_dp_train_step(CFG, tx, make_mesh(n_dp=2,
                                                              n_sp=1))
    batch = jax_collate([[ds[0]], [ds[2]]], CFG.buckets)
    args = shard_fn(batch, _fixed_clicks(2, 1, 50))
    new_p, new_bn, _, tot, _, gnorm, miou = step(
        params, runs["buffers"], runs["bn_state"], tx.init(params), *args,
        jnp.ones(2, jnp.float32))
    dp = runs["got"][0]["pair"]
    np.testing.assert_allclose(dp["loss"], float(tot), rtol=1e-4)
    np.testing.assert_allclose(dp["gnorm"], float(gnorm), rtol=1e-4)
    np.testing.assert_allclose(dp["miou"], float(miou), atol=1e-6)
    want = export_torch_state_dict(new_p, runs["buffers"], CFG.model, new_bn)
    model = ranks.model_from(PCFG.model, want)
    _same_states(dp["state"], ranks._state(model), atol=2 * 2e-3, rtol=0)
