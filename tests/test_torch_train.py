"""The port's training path against the JAX package's: the losses, the
click weights, the augmentation and object subsampling draws, the
optimizer against optax, and one whole supervised step at the reduced
width of ``tests/test_torch_model.py`` (f32 on the CPU, the same weights,
batch, clicks and labels on both sides).

Tolerances: losses and click weights at rtol 1e-5 (the same f32 formulas);
the optimizer at rtol 1e-5 / atol 1e-7 (the same update in another order);
the whole step at f32 scale through a backbone, a decoder and their
backward, summed in other orders: losses and gnorm rtol 1e-4, each
gradient max|diff| <= 2e-3 x max|grad| + 1e-7, BN statistics rtol 1e-4 /
atol 1e-6; updated parameters atol 1e-6 where |grad| >= 1e-6 (the first
AdamW update is lr * g / (|g| + eps), +-lr within 1% there) and 2 lr
elsewhere (where the update is as sensitive as the gradient itself)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.config import LossConfig as PortLossConfig
from agile3d_torch.config import TrainConfig as PortTrainConfig
from agile3d_torch.data.datasets import InterMultiObjDataset as PortDataset
from agile3d_torch.data.datasets import augment_coords as port_augment
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.data.synthetic import write_benchmark as port_write_benchmark
from agile3d_torch.engine import train as ptrain
from agile3d_torch.models import criterion as pcrit
from agile3d_torch.models.agile3d import Agile3D
from agile3d_torch.models.agile3d import ClickState as PortClicks
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.ckpt import (
    export_reference_state_dict,
    load_reference_state_dict,
)
from agile3d_tpu.config import Config, LossConfig, TrainConfig
from agile3d_tpu.data.datasets import InterMultiObjDataset, augment_coords
from agile3d_tpu.data.datasets import collate_scenes
from agile3d_tpu.engine import train as jtrain
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.models import criterion as jcrit
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_model import SMALL, port_model, randomized_weights, small_scene
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)


def _criterion_inputs(seed):
    rng = np.random.default_rng(seed)
    r, b, n, k = 3, 2, 96, 10
    num_obj = np.array([3, 5])
    logits = rng.standard_normal((r, b, n, 1 + k)).astype(np.float32) * 3
    for i, no in enumerate(num_obj):
        logits[:, i, :, no + 1:] = -1e9
    target = np.stack([rng.integers(0, no + 1, n) for no in num_obj]).astype(np.int32)
    valid = rng.random((b, n)) < 0.8
    raw = rng.random((b, n, 3)).astype(np.float32)
    click_vox = np.full((b, 8), -1, np.int32)
    click_vox[0, :3] = rng.choice(n, 3, replace=False)
    click_vox[1, :5] = rng.choice(n, 5, replace=False)
    return logits, target, valid, raw, click_vox


@pytest.mark.parametrize("losses,aux", [(("bce", "dice"), True),
                                        (("dice",), False)])
def test_criterion_and_click_weights_match_jax(losses, aux):
    logits, target, valid, raw, click_vox = _criterion_inputs(len(losses))
    jl = LossConfig(losses=losses, aux=aux)
    pl = PortLossConfig(losses=losses, aux=aux)
    want_w = np.asarray(jcrit.click_loss_weights(
        jnp.asarray(raw), jnp.asarray(valid), jnp.asarray(click_vox),
        jnp.asarray(click_vox >= 0), jl))
    got_w = pcrit.click_loss_weights(
        torch.from_numpy(raw), torch.from_numpy(valid),
        torch.from_numpy(click_vox), torch.from_numpy(click_vox >= 0), pl)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-6)
    assert (got_w.numpy()[~valid] == 0).all()

    want = jcrit.criterion_forward(jnp.asarray(logits), jnp.asarray(target),
                                   jnp.asarray(want_w), jnp.asarray(valid), jl)
    got = pcrit.criterion_forward(torch.from_numpy(logits),
                                  torch.from_numpy(target), got_w,
                                  torch.from_numpy(valid), pl)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    n_aux = jcrit.model_num_aux_rounds(SMALL)
    assert pcrit.model_num_aux_rounds(port_model_config(SMALL)) == n_aux
    wd = pcrit.loss_weight_dict(pl, n_aux)
    assert wd == jcrit.loss_weight_dict(jl, n_aux)
    np.testing.assert_allclose(float(pcrit.total_loss(got, wd)),
                               float(jcrit.total_loss(want, wd)), rtol=1e-5)


def test_augmentation_and_subsampling_draw_like_jax(tmp_path):
    """The same seeds give the same coordinates, object subsets and batch
    preparation (numpy draws in the same order)."""
    rng = np.random.default_rng(0)
    coords = rng.random((500, 3)).astype(np.float32) * 4
    for seed in range(6):
        np.testing.assert_array_equal(
            port_augment(coords, np.random.default_rng(seed)),
            augment_coords(coords, np.random.default_rng(seed)))

    labels = np.array([0, 1, 1, 5, 5, 5, 9, 3, 2, -1, -1], np.int32)
    jr, pr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        want, kw = jtrain.subsample_objects(labels, jr)
        got, kg = ptrain.subsample_objects(labels, pr)
        assert kg == kw
        np.testing.assert_array_equal(got, want)

    scans, lst = port_write_benchmark(str(tmp_path), num_scenes=3, num_obj=3,
                                      seed=4, n_points=1500)
    jds = InterMultiObjDataset(scans, lst, 0.05, augment=True, seed=11)
    pds = PortDataset(scans, lst, 0.05, augment=True, seed=11)
    jcfg, pcfg = Config(model=SMALL), PortConfig(model=port_model_config(SMALL))
    for ids, seed in (([0, 2], 5), ([1], 6)):
        jb, jl, jn, jv = jtrain.prepare_batch(jds, ids, jcfg, seed)
        pb, pl, pn, pv = ptrain.prepare_batch(pds, ids, pcfg, seed)
        np.testing.assert_array_equal(pb.raw, jb.raw)
        np.testing.assert_array_equal(pb.sample_idx, jb.sample_idx)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pn, jn)
        assert pv == jv


def test_optimizer_matches_optax():
    """Schedule across an lr_drop boundary, clipping above and below
    max_norm, and AdamW, over 7 steps."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, weight_decay=1e-2, lr_drop=(2,), lr_drop_gamma=0.1,
              clip_max_norm=1.0)
    tx, sched = jtrain.make_optimizer(Config(train=TrainConfig(**kw)), 2)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = ptrain.Optimizer(params, PortConfig(train=PortTrainConfig(**kw)), 2)
    for t in range(10):
        assert np.isclose(opt.lr(t), float(sched(t)), rtol=1e-6), t
    for t in range(7):
        scale = 10.0 if t % 2 == 0 else 0.01   # above, then below max_norm
        g = [rng.standard_normal(s).astype(np.float32) * scale for s in shapes]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        gnorm = opt.step()
        np.testing.assert_allclose(float(gnorm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7, err_msg=str(t))


def _capture():
    """An optax stage that passes the updates on and keeps them as its
    state: chained in front, it hands the step's raw gradients out."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _step_inputs(jcfg):
    (s1, p1), (s2, p2) = small_scene(9), small_scene(10, n_points=1200)
    jb = collate_scenes([s1, s2], jcfg.buckets, stem_banded=False)
    pb = port_collate([p1, p2], jcfg.buckets)
    rng = np.random.default_rng(3)
    labels, num_obj = jb.labels.copy(), np.zeros(2, np.int32)
    for i in range(2):
        labels[i], num_obj[i] = jtrain.subsample_objects(jb.labels[i], rng)
    # one click on every sampled object and the background, then extras
    vox = np.full((2, 32), -1, np.int32)
    obj = np.zeros((2, 32), np.int32)
    for i in range(2):
        rows = [int(rng.choice(np.nonzero(labels[i] == o)[0]))
                for o in range(num_obj[i] + 1) if (labels[i] == o).any()]
        rows += list(rng.choice(int((labels[i] >= 0).sum()), 4, replace=False))
        vox[i, :len(rows)] = rows
        obj[i, :len(rows)] = labels[i, rows]
    tm = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    return jb, pb, labels, num_obj, (vox, obj, tm)


def test_supervised_step_matches_jax():
    jcfg = Config(model=SMALL, train=TrainConfig(lr_drop=(5,)))
    pcfg = PortConfig(model=port_model_config(SMALL),
                      train=PortTrainConfig(lr_drop=(5,)))
    sd, params, buffers, bn_state = randomized_weights(
        SMALL, 3, np.random.default_rng(5))
    jb, pb, labels, num_obj, (vox, obj, tm) = _step_inputs(jcfg)
    assert pb.pyramid.levels[0].grid.shape == jb.pyramid.levels[0].grid.shape

    tx = optax.chain(_capture(), jtrain.make_optimizer(jcfg, 1)[0])
    step = jtrain.make_train_step(jcfg, tx)
    new_p, new_bn, new_opt, tot, losses, gnorm, miou = step(
        params, buffers, bn_state, tx.init(params), jb.pyramid,
        jnp.asarray(jb.feats), jnp.asarray(jb.raw), jnp.asarray(jb.sample_idx),
        jmodel.ClickState(jnp.asarray(vox), jnp.asarray(obj), jnp.asarray(tm)),
        jnp.asarray(labels), jnp.asarray(num_obj))
    grads = new_opt[0]

    model = port_model(SMALL, sd)
    opt, _ = ptrain.make_optimizer(model, pcfg, 1)
    out = ptrain.make_train_step(pcfg, model, opt)(
        (to_device(pb.pyramid, "cpu"), torch.from_numpy(pb.feats),
         torch.from_numpy(pb.raw), torch.from_numpy(pb.sample_idx)),
        PortClicks(*(torch.from_numpy(a) for a in (vox, obj, tm))),
        torch.from_numpy(labels), torch.from_numpy(num_obj))

    assert set(out["losses"]) == set(losses)
    for key, v in losses.items():
        np.testing.assert_allclose(float(out["losses"][key]), float(v),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(float(out["loss"]), float(tot), rtol=1e-4)
    np.testing.assert_allclose(float(out["gnorm"]), float(gnorm), rtol=1e-4)
    np.testing.assert_allclose(float(out["miou"]), float(miou), atol=1e-6)

    # the JAX gradients in the port's layout (through the reference
    # state-dict layout), scaled by the clip both sides applied
    gmodel = Agile3D(port_model_config(SMALL))
    load_reference_state_dict(
        gmodel, export_torch_state_dict(grads, buffers, SMALL, bn_state))
    clip = min(1.0, pcfg.train.clip_max_norm / float(gnorm))
    want_g = dict(gmodel.named_parameters())
    n_checked = 0
    for name, p in model.named_parameters():
        w = want_g[name].detach().numpy() * clip
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 2e-3 * np.abs(w).max() + 1e-7, (name, err)
        n_checked += 1
    assert n_checked == len(want_g)

    # updated parameters and committed BatchNorm statistics
    want_sd = export_torch_state_dict(new_p, buffers, SMALL, new_bn)
    got_sd = export_reference_state_dict(model)
    grad_sd = export_reference_state_dict(gmodel)
    lr = pcfg.train.lr
    n_bn = 0
    for key, got in got_sd.items():
        want = np.asarray(want_sd[key])
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            n_bn += not np.array_equal(got, np.asarray(sd[key]))
        elif key in grad_sd:
            # the first AdamW step moves a parameter by lr * g / (|g| + eps):
            # +-lr within 1% where |g| >= 1e-6, as sensitive as g below that
            sure = np.abs(grad_sd[key] * clip) >= 1e-6
            diff = np.abs(got - want)
            assert diff[sure].max(initial=0.0) <= 1e-6, key
            assert diff.max(initial=0.0) <= 2 * lr, key
    assert n_bn > 0
