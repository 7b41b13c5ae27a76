"""The port's multi-object eval rollout against the JAX package's host
rollout: same synthetic scene files, same weights, same ``random.Random``
seed. The row schedule (``id scene obj clicks``) must be identical and
every IoU within 1e-4; the port's evaluator scores a CSV exactly as the JAX
package's does."""

import filecmp
import os
import random

import numpy as np
import pytest
import torch

from agile3d_torch.config import Config as PortConfig
from agile3d_torch.data.datasets import InterMultiObjDataset as PortDataset
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.data.synthetic import write_benchmark as port_write_benchmark
from agile3d_torch.engine import eval as peval
from agile3d_torch.evaluation.evaluators import EvaluatorMO as PortEvaluatorMO
from agile3d_torch.utils.misc import MetricLogger as PortMetricLogger
from agile3d_tpu.config import Config
from agile3d_tpu.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_tpu.engine import eval as jeval
from agile3d_tpu.evaluation import EvaluatorMO
from agile3d_tpu.utils.misc import MetricLogger as JaxMetricLogger
from tests.synthetic import write_benchmark
from tests.test_torch_model import SMALL, port_model, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

MAX_NUM_CLICKS = 3
ROLLOUT_SEED = 13


@pytest.fixture(scope="module")
def rollouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    scans, val_list = write_benchmark(str(root / "jax"), num_scenes=1,
                                      num_obj=3, seed=11, n_points=1500)
    pscans, pval_list = port_write_benchmark(str(root / "port"), num_scenes=1,
                                             num_obj=3, seed=11, n_points=1500)
    sd, params, buffers, bn_state = randomized_weights(
        SMALL, 42, np.random.default_rng(0))

    jcfg = Config(model=SMALL)
    jbatch = collate_scenes([InterMultiObjDataset(scans, val_list, 0.05)[0]],
                            jcfg.buckets)
    jmeter, pmeter = JaxMetricLogger(), PortMetricLogger()
    jrows = jeval.evaluate_scene(
        jeval.InteractiveEngine(jcfg), params, buffers, bn_state, jbatch,
        mode="multi", instance_id=0, rng=random.Random(ROLLOUT_SEED),
        max_num_clicks=MAX_NUM_CLICKS, loss_meter=jmeter)

    pcfg = PortConfig(model=port_model_config(SMALL))
    pbatch = port_collate([PortDataset(pscans, pval_list, 0.05)[0]],
                          pcfg.buckets)
    engine = peval.InteractiveEngine(pcfg, port_model(SMALL, sd), device="cpu")
    prows = peval.evaluate_scene(engine, pbatch, instance_id=0,
                                 rng=random.Random(ROLLOUT_SEED),
                                 max_num_clicks=MAX_NUM_CLICKS,
                                 loss_meter=pmeter)
    return dict(root=root, scans=(scans, pscans), val_list=val_list,
                jrows=jrows, prows=prows, jbatch=jbatch, pbatch=pbatch,
                meters=(jmeter, pmeter))


def test_validation_loss_meter_matches_jax(rollouts):
    """The meter of ``evaluate_scene``'s model rounds (JAX's ``_val_losses``,
    the same click bucket and padded labels): the same keys and counts, and
    each mean within rtol 1e-4 (the losses' own tolerance in
    ``tests/test_torch_train.py``)."""
    jmeter, pmeter = rollouts["meters"]
    assert list(pmeter.meters) == list(jmeter.meters) == [
        "loss", "loss_bce", "loss_dice"]
    for k, m in jmeter.meters.items():
        p = pmeter.meters[k]
        assert p.count == m.count > 0, k
        np.testing.assert_allclose(p.global_avg, m.global_avg, rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(sorted(p.deque), sorted(m.deque),
                                   rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="host loop"):
        peval.evaluate_dataset(None, [], "unused.csv", device_rollout=True,
                               loss_meter=pmeter)


def test_synthetic_files_are_identical(rollouts):
    scans, pscans = rollouts["scans"]
    names = sorted(os.listdir(scans))
    assert names == sorted(os.listdir(pscans))
    for n in names:
        assert filecmp.cmp(os.path.join(scans, n), os.path.join(pscans, n),
                           shallow=False), n


def test_batches_are_identical(rollouts):
    j, p = rollouts["jbatch"], rollouts["pbatch"]
    for f in ("feats", "raw", "sample_idx", "labels", "num_obj"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    for a, b in zip(p.labels_full + p.inverse_map, j.labels_full + j.inverse_map):
        np.testing.assert_array_equal(a, b)
    assert p.scene_names == j.scene_names and p.obj_tags == j.obj_tags


def test_row_schedule_and_ious_match_jax(rollouts):
    got = [r.split(" ") for r in rollouts["prows"]]
    want = [r.split(" ") for r in rollouts["jrows"]]
    # budget 9 clicks: rounds at 0, 3, 4, ..., 9 -> 8 rows
    assert len(want) == 8
    assert [g[:4] for g in got] == [w[:4] for w in want]
    np.testing.assert_allclose([float(g[4]) for g in got],
                               [float(w[4]) for w in want], rtol=0, atol=1e-4)
    assert all(0.0 <= float(g[4]) <= 1.0 for g in got)


def test_evaluator_matches_jax(rollouts, tmp_path):
    csv = str(tmp_path / "rows.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rollouts["prows"]) + "\n")
    got = PortEvaluatorMO(rollouts["val_list"], csv).eval_results()
    want = EvaluatorMO(rollouts["val_list"], csv).eval_results()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)


def test_evaluator_noc_fallback_matches_jax(tmp_path):
    """Rows that reach tau, rows that never do (the clicks >= 20 fallback)
    and a scene outside the validation list."""
    rows = ["0 0000_00 2 0.0 0.1", "0 0000_00 2 1.0 0.55",
            "0 0000_00 2 3.0 0.82", "0 0000_00 2 20.0 0.86",
            "1 0001_00 3 1.0 0.2", "1 0001_00 3 20.0 0.3",
            "1 0001_00 3 25.0 0.95", "2 0009_00 1 1.0 0.99"]
    csv = str(tmp_path / "r.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    val = {"scene0000_00_obj_2": {}, "scene0001_00_obj_3": {}}
    got = PortEvaluatorMO(val, csv).eval_results()
    want = EvaluatorMO(val, csv).eval_results()
    assert got == want


def test_device_must_exist_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        peval.resolve_device("cuda")
    assert peval.resolve_device("cpu").type == "cpu"
