"""The port's eval rollouts with the voxel axis sharded
(``agile3d_torch/parallel/sp_rollout.py`` and the SP branch of
``engine/eval.py``) on a spawned 2-rank ``gloo`` group, against the port's
one-process device rollout on the scene of the JAX SP-rollout tests
(``write_benchmark(num_obj=2, n_points=1500)``, 3 clicks an object) at the
reduced width of ``tests/test_torch_model.py``.

The device rollout and the host loop, with the f32 and the bf16 decoder,
and with the sharded backbone: rows within 1e-4 in f32 and 2e-2 in bf16
(the bands of the JAX package's ``tests/test_sp_rollout.py``, a
distributed softmax against a one-process one), the ID, scene, object and
click columns equal, and every rank's rows the same. The sharded round's distance call on the
kernel is held in ``tests/test_torch_cuda_kernels.py`` (card only)."""

import dataclasses
import random

import pytest

from agile3d_torch.config import BackboneConfig, Config, ModelConfig
from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.device_eval import evaluate_scene_device
from agile3d_torch.engine.eval import InteractiveEngine
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.parallel.mesh import spawn
from agile3d_torch.utils.ckpt import export_reference_state_dict
from tests import torch_parallel_ranks as ranks

# tests/test_torch_model.py's SMALL, in the port's config
SMALL = ModelConfig(hidden_dim=32, dim_feedforward=64, num_heads=4,
                    max_clicks=64, backbone=BackboneConfig(
                        init_dim=16, planes=(16, 16, 32, 32, 32, 32, 32, 32),
                        layers=(1,) * 8))
BUCKETS = (2048, 4096)
MAX_NUM_CLICKS = 3
SEED = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfg(dtype):
    return Config(model=dataclasses.replace(SMALL, decoder_dtype=dtype),
                  buckets=BUCKETS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sp_rollout"))
    scans, val_list = write_benchmark(root, num_scenes=1, num_obj=2,
                                      n_points=1500)
    batch = collate_scenes([InterMultiObjDataset(scans, val_list, 0.05)[0]],
                           BUCKETS)
    sd = export_reference_state_dict(init_agile3d(SMALL, seed=0,
                                                  device="cpu"))
    want = {}
    for dtype in TOL:
        engine = InteractiveEngine(_cfg(dtype), ranks.model_from(
            _cfg(dtype).model, sd), "cpu")
        want[dtype] = evaluate_scene_device(
            engine, batch, instance_id=0, rng=random.Random(SEED),
            max_num_clicks=MAX_NUM_CLICKS)
    keys = [(dtype, bb, host) for dtype in TOL for bb in (False, True)
            for host in (False, True) if not (bb and dtype == "bfloat16")]
    got = spawn(ranks.sp_rollout_cases, 2,
                [(_cfg(dtype), sd, batch, SEED, MAX_NUM_CLICKS, bb, host)
                 for dtype, bb, host in keys], device="cpu")
    return want, {k: [g[i] for g in got] for i, k in enumerate(keys)}


def _rows_close(a, b, tol):
    assert len(a) == len(b) == 1 + 2 * MAX_NUM_CLICKS - 2 + 1
    for ra, rb in zip(a, b):
        fa, fb = ra.split(" "), rb.split(" ")
        assert fa[:4] == fb[:4], (ra, rb)
        assert abs(float(fa[4]) - float(fb[4])) < tol, (ra, rb)


@pytest.mark.parametrize("dtype,sp_backbone,host", [
    ("float32", False, False), ("float32", False, True),
    ("bfloat16", False, False), ("bfloat16", False, True),
    ("float32", True, False), ("float32", True, True)],
    ids=["device", "host", "device-bf16", "host-bf16", "sp_backbone-device",
         "sp_backbone-host"])
def test_sp_rows_match_one_process_device_rollout(runs, dtype, sp_backbone,
                                                  host):
    want, got = runs
    rank_rows = got[(dtype, sp_backbone, host)]
    assert rank_rows[0] == rank_rows[1]
    _rows_close(rank_rows[0], want[dtype], TOL[dtype])

