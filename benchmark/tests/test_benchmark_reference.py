"""The plain reference against the port's plain path at a tiny size on the
CPU: the same voxels, the same rows, the same features and logits."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.gen import scenes as gen
from benchmark.harness.seeds import np_rng
from benchmark.kinds.program import load_weights, program_config
from benchmark.reference import clicks as rc
from benchmark.reference import model as rm
from benchmark.reference import sparse as rs
from benchmark.reference import train as rt
from benchmark.tests.tiny import ROOT


@pytest.fixture(scope="module")
def setup():
    with open(os.path.join(ROOT, "benchmark/configs/"
                                 "agile3d-34c-scannet40.json")) as f:
        cfg = json.load(f)
    coords, colors, labels = gen.scene_from(
        {"points": 4000, "extent": 3.0, "objects": 3, "noise": 0.03},
        np_rng(5, "scenes"))
    coords = coords - coords.min(0, keepdims=True)
    w = rm.make_weights(cfg, 123, "cpu")
    return cfg, coords, colors, labels, w


def _program(cfg, w, coords, colors, labels, decoder_dtype="float32"):
    from agile3d_torch.data.datasets import SceneSample, collate_scenes
    from agile3d_torch.engine.eval import InteractiveEngine
    from agile3d_torch.models.agile3d import Agile3D
    from agile3d_torch.sparse.quantize import sparse_quantize

    pcfg = program_config(cfg, decoder_dtype)
    model = Agile3D(pcfg.model)
    load_weights(model, w)
    eng = InteractiveEngine(pcfg, model, "cpu")
    vox, um, im = sparse_quantize(coords, 0.05)
    feats = colors.astype(np.float32) / 255.0
    s = SceneSample(vox, coords[um], feats[um], labels[um], labels, im, {},
                    "s", 3)
    return eng, vox, um, im, eng.run_backbone(collate_scenes([s],
                                                            pcfg.buckets))


def test_voxels_and_features(setup):
    cfg, coords, colors, labels, w = setup
    eng, vox, um, im, scene = _program(cfg, w, coords, colors, labels)
    v = rs.voxelize(torch.from_numpy(coords), 0.05)
    np.testing.assert_array_equal(v.grid.numpy(), vox)
    np.testing.assert_array_equal(v.first.numpy(), um)
    np.testing.assert_array_equal(v.inverse.numpy(), im)
    lv = rs.pyramid(v.grid, torch.zeros(len(v.grid), dtype=torch.long))
    feats = torch.from_numpy(colors.astype(np.float32) / 255.0)[v.first]
    fm = rm.backbone(w, lv, feats)
    sc = rm.scene_features(w, fm, [torch.arange(len(v.grid))],
                           torch.from_numpy(coords)[v.first])
    n = len(vox)
    ref = sc.feat[0]
    assert float((ref - scene.mask_feat[0, :n]).abs().max()) \
        <= 1e-5 * float(ref.abs().max())


@torch.no_grad()
def test_decoder_follows_the_program(setup):
    from agile3d_torch.engine.clicks import HostClicks, NewClicks
    from agile3d_torch.engine.eval import stack_clicks

    cfg, coords, colors, labels, w = setup
    eng, vox, um, im, scene = _program(cfg, w, coords, colors, labels)
    n = len(vox)
    rng = np.random.default_rng(0)
    cl = HostClicks(256)
    cl.extend(NewClicks(rng.integers(0, n, 7).astype(np.int32),
                        np.array([1, 2, 3, 1, 2, 3, 0], np.int32),
                        np.arange(7, dtype=np.int32)))
    cs = stack_clicks([cl], 32, "cpu")
    out = eng.model.forward_mask(scene, cs, torch.tensor([3]))
    prog = out["all_masks"][:, 0, :n]
    v = rs.voxelize(torch.from_numpy(coords), 0.05)
    lv = rs.pyramid(v.grid, torch.zeros(len(v.grid), dtype=torch.long))
    feats = torch.from_numpy(colors.astype(np.float32) / 255.0)[v.first]
    sc = rm.scene_features(w, rm.backbone(w, lv, feats),
                           [torch.arange(n)], torch.from_numpy(coords)[v.first])
    mine = rm.decoder(w, cfg, sc, cs.vox, cs.obj, cs.time,
                      torch.tensor([3]))[:, 0]
    cols = slice(0, 4)
    assert float((mine - prog)[..., cols].abs().max()) \
        <= 1e-4 * float(mine[..., cols].abs().max())


def test_first_round_clicks_match_the_program(setup):
    import random

    from agile3d_torch.engine.clicks import simulate_clicks

    cfg, coords, colors, labels, _ = setup
    v = rs.voxelize(torch.from_numpy(coords), 0.05)
    lab = torch.from_numpy(labels.astype(np.int64))[v.first]
    raw = torch.from_numpy(coords)[v.first]
    new = simulate_clicks(np.zeros(len(lab), np.int32), lab.numpy(),
                          raw.numpy(), num_obj=3, training=False,
                          current_num_clicks=0, rng=random.Random(4),
                          device="cpu")
    mine = rc.first_round(lab, raw, 10, random.Random(4))
    assert list(zip(new.vox.tolist(), new.obj.tolist())) == mine


def test_training_loss_follows_the_program(setup):
    """One supervised loss of the port's training forward against the
    reference's, on the same batch and clicks."""
    from agile3d_torch.data.datasets import SceneSample, collate_scenes
    from agile3d_torch.engine.train import supervised_forward
    from agile3d_torch.models.agile3d import Agile3D, ClickState
    from agile3d_torch.models.criterion import (
        loss_weight_dict,
        model_num_aux_rounds,
    )
    from agile3d_torch.sparse.grid import to_device
    from agile3d_torch.sparse.quantize import sparse_quantize

    cfg, coords, colors, labels, w = setup
    pcfg = program_config(cfg)
    model = Agile3D(pcfg.model)
    load_weights(model, w)
    samples = []
    for shift in (0.0, 0.37):
        c = (coords + shift).astype(np.float32)
        vox, um, im = sparse_quantize(c, 0.05)
        samples.append(SceneSample(vox, c[um], colors[um].astype(
            np.float32) / 255.0, labels[um], labels, im, {}, "s", 3))
    batch = collate_scenes(samples, pcfg.buckets)
    mc = 32
    vox_t = torch.full((2, mc), -1, dtype=torch.int32)
    vox_t[:, :4] = torch.tensor([[5, 9, 100, 200], [7, 8, 150, 300]])
    obj_t = torch.zeros((2, mc), dtype=torch.int32)
    obj_t[:, :4] = torch.tensor([[1, 2, 3, 0], [2, 1, 3, 0]])
    tim_t = torch.arange(mc, dtype=torch.int32).repeat(2, 1)
    lab = torch.from_numpy(batch.labels).long()
    dev_batch = (to_device(batch.pyramid, "cpu"),
                 torch.from_numpy(batch.feats), torch.from_numpy(batch.raw),
                 torch.from_numpy(batch.sample_idx))
    wd = loss_weight_dict(pcfg.loss, model_num_aux_rounds(pcfg.model))
    *_, prog = supervised_forward(pcfg, model, wd, dev_batch,
                                  ClickState(vox_t, obj_t, tim_t), lab,
                                  torch.tensor([3, 3]), None, {})
    ref_batch = rt.Batch([((coords + s).astype(np.float32), colors, labels)
                          for s in (0.0, 0.37)], 0.05, "cpu", 10, 0)
    ref_batch.labels = torch.where(ref_batch.labels >= 0, torch.from_numpy(
        batch.labels).long()[:, :ref_batch.labels.shape[1]], -1)
    ref_batch.num_obj = torch.tensor([3, 3])
    mine, *_ = rt.forward_loss(w, cfg, ref_batch, (vox_t.long(),
                                                  obj_t.long(), tim_t.long()))
    prog, mine = float(prog.detach()), float(mine.detach())
    assert abs(prog - mine) <= 1e-5 * abs(mine)
