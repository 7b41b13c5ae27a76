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
    assert sum(str(m).startswith("Epoch: [0]") for m in logged) == 2
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
