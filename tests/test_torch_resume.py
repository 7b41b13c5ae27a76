"""Resumable training in the port against the JAX package's: the optax
AdamW state carried across (``utils/ckpt.py::optimizer_state_from_optax``)
takes the same next step as JAX's, the port's checkpoint save -> load is
exact, and ``python -m agile3d_torch.main`` follows the JAX ``main.py``'s
``--resume`` / ``--start_epoch`` / ``--ckpt_epochs`` rules.

Tolerances. Given the same gradients, the carried optimizer's step equals
JAX's at f32 tolerance (parameters rtol 1e-5, atol 1e-7, as
``tests/test_torch_train.py`` holds the optimizer; moments 1e-5 of each
tensor's largest entry; the count exactly). Through each side's own supervised step the gradients differ at
~2e-3 of their size (``tests/test_torch_train.py``), which AdamW's
per-entry normalisation turns into up to ~2 lr on near-zero entries, so
that step is held by direction: each parameter's update within cosine
0.995 of JAX's and 10% of its norm (measured: >= 0.99866 and <= 5.2%, both
at a BatchNorm bias, whose gradient cancels most); the moments follow the
gradients and are held by the first test."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import main as jax_main
from agile3d_torch import main as pmain
from agile3d_torch.config import Config as PortConfig
from agile3d_torch.config import TrainConfig as PortTrainConfig
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine import train as ptrain
from agile3d_torch.models.agile3d import ClickState as PortClicks
from agile3d_torch.sparse.grid import to_device
from agile3d_torch.utils.ckpt import (
    export_reference_state_dict,
    load_training_checkpoint,
    optimizer_state_from_optax,
    save_checkpoint,
)
from agile3d_tpu.config import Config, TrainConfig
from agile3d_tpu.engine import train as jtrain
from agile3d_tpu.models import agile3d as jmodel
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_model import SMALL, port_model, randomized_weights
from tests.test_torch_train import _capture, _step_inputs
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-7)
UPDATE_COS = 0.995
UPDATE_REL = 0.1


@pytest.fixture(scope="module")
def steps():
    """Two JAX supervised steps from one state (each step's raw gradients
    kept by a capturing stage chained in front of the optimizer), and the
    port's model and optimizer carried across from a JAX state."""
    train = dict(lr_drop=(5,))
    jcfg = Config(model=SMALL, train=TrainConfig(**train))
    pcfg = PortConfig(model=port_model_config(SMALL),
                      train=PortTrainConfig(**train))
    sd, params, buffers, bn_state = randomized_weights(
        SMALL, 3, np.random.default_rng(5))
    jb, pb, labels, num_obj, (vox, obj, tm) = _step_inputs(jcfg)
    tx = optax.chain(_capture(), jtrain.make_optimizer(jcfg, 1)[0])
    step = jtrain.make_train_step(jcfg, tx)
    jargs = (jb.pyramid, jnp.asarray(jb.feats), jnp.asarray(jb.raw),
             jnp.asarray(jb.sample_idx),
             jmodel.ClickState(jnp.asarray(vox), jnp.asarray(obj),
                               jnp.asarray(tm)),
             jnp.asarray(labels), jnp.asarray(num_obj))
    p1, bn1, opt1, *_ = step(params, buffers, bn_state, tx.init(params),
                             *jargs)
    p2, bn2, opt2, *_ = step(p1, buffers, bn1, opt1, *jargs)

    def carried(p, bn, opt):
        """The port's model and optimizer holding JAX's state."""
        ref = lambda tree: export_torch_state_dict(tree, buffers, SMALL, bn)
        model = port_model(SMALL, ref(p))
        optimizer, _ = ptrain.make_optimizer(model, pcfg, 1)
        adam = opt[1][1][0]        # (capture, (clip, (adam, decay, lr)))
        optimizer.load_state_dict(optimizer_state_from_optax(
            model, int(adam.count), ref(adam.mu), ref(adam.nu)))
        return model, optimizer

    # the second step's raw gradients in the port's layout
    gmodel = port_model(SMALL, export_torch_state_dict(opt2[0], buffers,
                                                       SMALL, bn2))
    grads2 = {n: p.detach().clone() for n, p in gmodel.named_parameters()}
    port_batch = (to_device(pb.pyramid, "cpu"), torch.from_numpy(pb.feats),
                  torch.from_numpy(pb.raw), torch.from_numpy(pb.sample_idx))
    port_args = (PortClicks(*(torch.from_numpy(a) for a in (vox, obj, tm))),
                 torch.from_numpy(labels), torch.from_numpy(num_obj))
    return dict(pcfg=pcfg, buffers=buffers, carried=carried, grads2=grads2,
                first=(p1, bn1, opt1), second=(p2, bn2, opt2),
                port_batch=port_batch, port_args=port_args)


def _moments(opt):
    return opt.state_dict()["params"]


def test_carried_optax_state_takes_the_same_next_step(steps):
    """JAX's state after one step, carried across, then the second step's
    gradients on each side: equal parameters, moments and count."""
    model, opt = steps["carried"](*steps["first"])
    assert opt.count == 1 and opt.lr(opt.count) == steps["pcfg"].train.lr
    for name, p in model.named_parameters():
        p.grad = steps["grads2"][name].clone()
    opt.step()
    want_model, want_opt = steps["carried"](*steps["second"])
    assert opt.count == want_opt.count == 2
    want = dict(want_model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), **F32_TOL,
                                   err_msg=name)
    got_st, want_st = _moments(opt), _moments(want_opt)
    assert set(got_st) == set(want_st) == set(want)
    for name, st in want_st.items():
        assert float(got_st[name]["step"]) == float(st["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            err = float((got_st[name][key] - st[key]).abs().max())
            assert err <= 1e-5 * float(st[key].abs().max()), (name, key, err)


def test_carried_state_through_the_supervised_step(steps):
    """The same, with each side's own supervised step (forward, backward,
    clip, AdamW) on the batch JAX stepped on."""
    model, opt = steps["carried"](*steps["first"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = ptrain.make_train_step(steps["pcfg"], model, opt)(
        steps["port_batch"], *steps["port_args"])
    assert np.isfinite(float(out["loss"])) and opt.count == 2
    want_model, want_opt = steps["carried"](*steps["second"])
    want = dict(want_model.named_parameters())
    gnorm = sum(float(g.norm()) ** 2 for g in steps["grads2"].values()) ** 0.5
    for name, p in model.named_parameters():
        if float(steps["grads2"][name].norm()) <= 1e-6 * gnorm:
            continue   # zero in exact arithmetic: rounding noise both sides
        du = (p.detach() - before[name]).flatten()
        dw = (want[name].detach() - before[name]).flatten()
        cos = float(torch.nn.functional.cosine_similarity(du, dw, dim=0))
        assert cos >= UPDATE_COS, (name, cos)
        assert float((du - dw).norm() / dw.norm()) <= UPDATE_REL, name
    assert want_opt.count == 2
    # the BatchNorm statistics the step committed, in the reference layout
    got_sd = export_reference_state_dict(model)
    want_sd = export_torch_state_dict(steps["second"][0], steps["buffers"],
                                      SMALL, steps["second"][1])
    for k in got_sd:
        if "running" in k:
            np.testing.assert_allclose(got_sd[k], np.asarray(want_sd[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_save_then_load_is_exact(steps, tmp_path):
    model, opt = steps["carried"](*steps["first"])
    ptrain.make_train_step(steps["pcfg"], model, opt)(
        steps["port_batch"], *steps["port_args"])
    path = str(tmp_path / "checkpoint.pth")
    save_checkpoint(path, model, 7, opt)
    assert not os.path.exists(path + ".tmp")

    fresh, fresh_opt = steps["carried"](*steps["first"])
    assert fresh_opt.count == 1
    assert load_training_checkpoint(path, fresh, fresh_opt) == 7
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               fresh.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert fresh_opt.count == opt.count == 2
    assert fresh_opt.lr(fresh_opt.count) == opt.lr(opt.count)
    got, want = fresh_opt.state_dict()["params"], opt.state_dict()["params"]
    assert set(got) == set(want)
    for name, st in want.items():
        for key, v in st.items():
            assert torch.equal(got[name][key], v), (name, key)


def test_optimizer_state_refuses_other_parameters(steps):
    model, opt = steps["carried"](*steps["first"])
    sd = opt.state_dict()
    del sd["params"]["decoder_norm.bias"]
    with pytest.raises(KeyError, match="decoder_norm.bias"):
        opt.load_state_dict(sd)


def test_weights_only_pth_leaves_the_optimizer_fresh(steps, tmp_path):
    """A ``.pth`` without optimizer state (the reference's released one is
    such a file) loads the weights and returns None."""
    model, opt = steps["carried"](*steps["first"])
    path = str(tmp_path / "weights.pth")
    save_checkpoint(path, model, 1099)
    fresh = port_model(SMALL, export_reference_state_dict(
        steps["carried"](*steps["second"])[0]))
    fresh_opt, _ = ptrain.make_optimizer(fresh, steps["pcfg"], 1)
    assert load_training_checkpoint(path, fresh, fresh_opt) is None
    assert fresh_opt.count == 0 and fresh_opt.state_dict()["params"] == {}
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k


def _cli_args(tmp_path, data, *extra):
    scans, lst = data
    return pmain.get_args_parser().parse_args([
        "--scan_folder", scans, "--train_list", lst, "--val_list", lst,
        "--batch_size", "2", "--val_epochs", "50",
        "--output_dir", str(tmp_path / "out"), "--seed", "0",
        "--device", "cpu", *extra])


@pytest.fixture
def small_main(monkeypatch, tmp_path):
    # the training rollout's clicks need more than SMALL's 32 slots
    small = dataclasses.replace(port_model_config(SMALL), max_clicks=256)
    build = pmain.build_config
    monkeypatch.setattr(pmain, "build_config",
                        lambda args: dataclasses.replace(build(args),
                                                         model=small))
    return write_benchmark(str(tmp_path / "data"), num_scenes=2, num_obj=3,
                           seed=2, n_points=1200)


def test_resume_continues_at_the_next_epoch(small_main, tmp_path):
    """One epoch, then ``--resume checkpoint.pth --epochs 2``: the resumed
    run starts at epoch 1 with the saved optimizer state and runs one
    epoch."""
    first = pmain.main(_cli_args(tmp_path, small_main, "--epochs", "1"),
                       log=lambda m: None)
    path = str(tmp_path / "out" / "checkpoint.pth")
    ckpt = torch.load(path, weights_only=False)
    assert ckpt["epoch"] == 0 and ckpt["optimizer"]["count"] == 1
    saved = {k: v.clone() for k, v in first["model"].state_dict().items()}

    logged = []
    second = pmain.main(_cli_args(tmp_path, small_main, "--epochs", "2",
                                  "--resume", path), log=logged.append)
    assert second["start_epoch"] == 1 and len(second["epochs"]) == 1
    assert any(str(m).startswith("Epoch: [1]") for m in logged)
    assert not any(str(m).startswith("Epoch: [0]") for m in logged)
    assert second["optimizer"].count == 2
    ckpt = torch.load(path, weights_only=False)
    assert ckpt["epoch"] == 1 and ckpt["optimizer"]["count"] == 2
    moved = [k for k, v in second["model"].state_dict().items()
             if not torch.equal(v, saved[k])]
    assert "backbone.block8.0.conv2.kernel" in moved


def test_resume_from_weights_keeps_start_epoch(small_main, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(pmain, "train_one_epoch",
                        lambda *a, **k: {"loss": 1.0})
    model = pmain.init_agile3d(port_model_config(SMALL), seed=3,
                               device="cpu")
    weights = str(tmp_path / "checkpoint1099.pth")
    save_checkpoint(weights, model, 1099)
    hist = pmain.main(_cli_args(tmp_path, small_main, "--epochs", "7",
                                "--start_epoch", "5", "--resume", weights),
                      log=lambda m: None)
    assert hist["start_epoch"] == 5 and len(hist["epochs"]) == 2
    assert hist["optimizer"].count == 0
    for k, v in model.state_dict().items():
        assert torch.equal(hist["model"].state_dict()[k], v), k


def test_ckpt_epochs_file_rule(small_main, tmp_path, monkeypatch):
    """``--epochs 3 --ckpt_epochs 2 --lr_drop 2``: the rolling checkpoint
    after epochs 1 and 2 (the cadence, then the last epoch), the archival
    copy before the LR drop, as the JAX ``main.py`` writes them."""
    monkeypatch.setattr(pmain, "train_one_epoch",
                        lambda *a, **k: {"loss": 1.0})
    written = []
    save = pmain.save_checkpoint

    def spy(path, model, epoch, optimizer=None):
        written.append((os.path.basename(path), epoch))
        save(path, model, epoch, optimizer)

    monkeypatch.setattr(pmain, "save_checkpoint", spy)
    pmain.main(_cli_args(tmp_path, small_main, "--epochs", "3",
                         "--ckpt_epochs", "2", "--lr_drop", "2"),
               log=lambda m: None)
    assert written == [("checkpoint.pth", 1), ("checkpoint0001.pth", 1),
                       ("checkpoint.pth", 2)]
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["checkpoint.pth", "checkpoint0001.pth",
                                       "valResults"]
    assert torch.load(str(out / "checkpoint.pth"),
                      weights_only=False)["epoch"] == 2


@pytest.mark.parametrize("value", ["0", "-3"])
def test_ckpt_epochs_below_one_exits_as_jax(value):
    argv = ["--ckpt_epochs", value, "--device", "cpu"]
    with pytest.raises(SystemExit) as want:
        jax_main.main(jax_main.get_args_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        pmain.main(pmain.get_args_parser().parse_args(argv))
    assert str(got.value) == str(want.value) == (
        f"--ckpt_epochs must be >= 1, got {value}")
