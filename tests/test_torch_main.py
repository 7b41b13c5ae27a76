"""The port's training entry point (``python -m agile3d_torch.main``) end
to end on the CPU: synthetic scenes, the reduced width of
``tests/test_torch_model.py``, one epoch of two steps and one validation.
It must give finite losses, move the weights and the BatchNorm running
statistics, and write a reference-layout ``checkpoint.pth`` that loads
back equal into a fresh model; and the training rollout's batched decoder
call must give each sample the labels of a decoder call on it alone."""

import dataclasses
import math
import os
import random

import numpy as np
import pytest
import torch

from agile3d_torch import main as pmain
from agile3d_torch.config import Config
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.clicks import HostClicks
from agile3d_torch.engine.eval import InteractiveEngine
from agile3d_torch.engine.train import prepare_batch, rollout_clicks
from agile3d_torch.models.agile3d import Agile3D, init_agile3d
from agile3d_torch.utils.ckpt import load_checkpoint
from tests.test_torch_model import SMALL
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)


def test_training_entry_point_on_cpu(tmp_path, monkeypatch):
    small = port_model_config(SMALL)
    build = pmain.build_config
    monkeypatch.setattr(pmain, "build_config",
                        lambda args: dataclasses.replace(build(args),
                                                         model=small))
    scans, lst = write_benchmark(str(tmp_path / "data"), num_scenes=3,
                                 num_obj=3, seed=2, n_points=1500)
    out_dir = str(tmp_path / "out")
    args = pmain.get_args_parser().parse_args([
        "--scan_folder", scans, "--train_list", lst, "--val_list", lst,
        "--epochs", "1", "--val_epochs", "1", "--batch_size", "2",
        "--max_num_clicks", "1", "--output_dir", out_dir, "--seed", "0",
        "--device", "cpu"])
    logged = []
    hist = pmain.main(args, log=logged.append)

    (stats,) = hist["epochs"]
    assert set(stats) == {"loss", "grad_norm", "mIoU", "loss_bce", "loss_dice"}
    assert all(math.isfinite(v) for v in stats.values())
    # MetricLogger.log_every: a line at each of the 2 steps, and the total
    assert sum(str(m).startswith("Epoch: [0]") for m in logged) == 3
    assert any(str(m).startswith("Epoch: [0] Total time: ") for m in logged)
    assert 0 in hist["val"] and "IoU@1" in hist["val"][0]
    assert os.path.exists(os.path.join(out_dir, "valResults",
                                       "val_results_epoch_0.csv"))

    trained = hist["model"]
    init = init_agile3d(small, seed=0, device="cpu")
    moved = {k for k, v in trained.state_dict().items()
             if not torch.equal(v, init.state_dict()[k])}
    assert "backbone.block8.0.conv2.kernel" in moved
    assert "backbone.bn0.bn.running_mean" in moved
    assert "backbone.block1.0.norm1.bn.running_var" in moved

    fresh = Agile3D(small)
    load_checkpoint(os.path.join(out_dir, "checkpoint.pth"), fresh)
    for k, v in trained.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_rollout_batch_call_matches_single_calls(tmp_path):
    """run_mask_batch on two samples gives each the argmax of run_mask on
    that sample alone (the batch's click tables are sliced to one bucket;
    padding slots are masked)."""
    scans, lst = write_benchmark(str(tmp_path), num_scenes=2, num_obj=3,
                                 seed=5, n_points=1500)
    cfg = Config(model=port_model_config(SMALL))
    from agile3d_torch.data.datasets import InterMultiObjDataset

    ds = InterMultiObjDataset(scans, lst, 0.05)
    batch, labels, num_obj, n_valid = prepare_batch(ds, [0, 1], cfg, 3)
    engine = InteractiveEngine(cfg, init_agile3d(cfg.model, seed=1,
                                                 device="cpu"), "cpu")
    scene = engine.run_backbone(batch, training=True)
    raw = [batch.raw[:n_valid[0]], batch.raw[n_valid[0]:sum(n_valid)]]
    clicks = rollout_clicks(engine, scene, labels, num_obj, raw, n_valid,
                            random.Random(4), cfg)
    assert all(isinstance(c, HostClicks) and c.count > 0 for c in clicks)
    both = engine.run_mask_batch(scene, clicks, num_obj)
    for i in range(2):
        one = type(scene)(*(t[i:i + 1] for t in scene))
        _, alone = engine.run_mask(one, clicks[i], int(num_obj[i]))
        np.testing.assert_array_equal(both[i, :n_valid[i]].numpy(),
                                      alone[0, :n_valid[i]].numpy())


def test_single_object_training_fails_where_jax_fails(tmp_path, monkeypatch):
    """``--dataset_mode single_obj`` in both packages' ``main.py``, at the
    reduced width: each trains an epoch (one batch of the three objects)
    on the single-object dataset
    (object list ``.npy``), writes its checkpoint, runs the validation
    rollout in the multi-object protocol (the same CSV row schedule), and
    then fails in ``EvaluatorMO``, which reads the ``.npy`` object list as
    JSON (a fault on the reference side, ROADMAP C4)."""
    import main as jax_main

    from tests.synthetic import write_benchmark as jax_write_benchmark

    monkeypatch.setenv("AGILE3D_CACHE", "0")
    scans, _ = jax_write_benchmark(str(tmp_path / "data"), num_scenes=2,
                                   num_obj=3, seed=2, n_points=1500)
    objects = np.array([["scene0000_00", "1"], ["scene0001_00", "2"],
                        ["scene0000_00", "3"]])
    train, val = str(tmp_path / "train.npy"), str(tmp_path / "val.npy")
    np.save(train, objects)
    np.save(val, objects[:1])
    small = dataclasses.replace(SMALL, max_clicks=256)
    argv = ["--dataset_mode", "single_obj", "--scan_folder", scans,
            "--train_list", train, "--val_list", val, "--epochs", "1",
            "--val_epochs", "1", "--batch_size", "3", "--max_num_clicks", "1",
            "--seed", "0", "--device", "cpu"]
    rows, where = {}, {}
    for name, module, cfg in (("jax", jax_main, small),
                              ("port", pmain, port_model_config(small))):
        build = module.build_config
        monkeypatch.setattr(module, "build_config", lambda args, b=build, c=cfg:
                            dataclasses.replace(b(args), model=c))
        out_dir = str(tmp_path / name)
        args = module.get_args_parser().parse_args(
            argv + ["--output_dir", out_dir])
        with pytest.raises(UnicodeDecodeError) as err:
            module.main(args) if name == "jax" else module.main(
                args, log=lambda m: None)
        where[name] = [(os.path.basename(str(e.path)), e.name)
                       for e in err.traceback]
        assert ("evaluators.py", "__init__") in where[name], where[name]
        assert os.path.exists(os.path.join(
            out_dir, "checkpoint" if name == "jax" else "checkpoint.pth"))
        with open(os.path.join(out_dir, "valResults",
                               "val_results_epoch_0.csv")) as f:
            rows[name] = [r.split(" ")[:4] for r in f.read().split("\n") if r]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2
    assert rows["port"][0][1:3] == ["0000_00", "1"]
