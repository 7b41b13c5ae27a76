"""Golden replay through the port: the ``tools/make_golden.py`` setup (JAX
init at seed 42 crossed into the port through the weight bridge, synthetic
scene seed 11, rollout seed 13) run by the port's eval at full
Res16UNet34C width on the CPU, for the multi-object golden
(``tests/golden/rollout_multi.csv``) and the single-object one
(``tests/golden/rollout_single.csv``, one instance per object). The row
schedule must equal the golden's exactly and every IoU must lie within
0.02 of it, the band of ``test_golden_rollout_device_tolerance``."""

import random

import jax
import numpy as np
import pytest
import torch

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.data.datasets import (
    InterMultiObjDataset,
    InterSingleObjDataset,
)
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.eval import InteractiveEngine, evaluate_dataset
from agile3d_torch.models.agile3d import Agile3D
from agile3d_torch.utils.ckpt import load_reference_state_dict
from agile3d_tpu.config import ModelConfig
from agile3d_tpu.models.agile3d import init_agile3d
from agile3d_tpu.utils.ckpt import export_torch_state_dict
from tests.test_torch_weights import port_model_config
from tools.make_golden import (
    GOLDEN_CSV,
    GOLDEN_SINGLE_CSV,
    MAX_CLICKS,
    N_POINTS,
    NUM_OBJ,
    NUM_SCENES,
    ROLLOUT_SEED,
    SCENE_SEED,
    WEIGHTS_SEED,
)

pytestmark = pytest.mark.slow  # full-width backbone rollout on the CPU

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["multi", "single"])
def test_port_replays_golden_rollout(tmp_path, mode):
    jcfg = ModelConfig(max_clicks=128)
    params, buffers, bn_state = init_agile3d(jax.random.PRNGKey(WEIGHTS_SEED),
                                             jcfg)
    model = Agile3D(port_model_config(jcfg))
    load_reference_state_dict(
        model, export_torch_state_dict(params, buffers, jcfg, bn_state))

    cfg = PortConfig(model=model.cfg)
    scans, val_list = write_benchmark(str(tmp_path / "bench"),
                                      num_scenes=NUM_SCENES, num_obj=NUM_OBJ,
                                      seed=SCENE_SEED, n_points=N_POINTS)
    if mode == "single":
        objects = np.array([["scene0000_00", str(o)]
                            for o in range(1, NUM_OBJ + 1)])
        ds = InterSingleObjDataset(scans, objects, cfg.model.voxel_size)
        golden, n_rows = GOLDEN_SINGLE_CSV, NUM_OBJ * (MAX_CLICKS + 1)
    else:
        ds = InterMultiObjDataset(scans, val_list, cfg.model.voxel_size)
        golden, n_rows = GOLDEN_CSV, 14
    out = str(tmp_path / "port.csv")
    evaluate_dataset(InteractiveEngine(cfg, model, device="cpu"), ds, out,
                     max_num_clicks=MAX_CLICKS, seed=ROLLOUT_SEED,
                     log=lambda *a: None, mode=mode)

    got = [r.split(" ") for r in open(out).read().strip().split("\n")]
    want = [r.split(" ") for r in open(golden).read().strip().split("\n")]
    assert len(got) == len(want) == n_rows
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        np.testing.assert_allclose(float(g[4]), float(w[4]), atol=0.02)
