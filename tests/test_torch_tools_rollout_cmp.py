"""The port's rollout-path comparison
(``agile3d_torch/tools/compare_rollout_paths.py``) against the repository's
JAX tool on the CPU: ``first_divergence`` on the same pairs of CSVs (equal
ones, one with a planted difference, one under the tolerance, a short
trajectory), then the tool end to end at the reduced width, its evaluator
dicts held against JAX's ``EvaluatorMO`` on its CSVs."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from agile3d_tpu.evaluation import EvaluatorMO as JaxEvaluatorMO
from agile3d_torch.config import Config
from agile3d_torch.models.agile3d import init_agile3d
from agile3d_torch.tools import compare_rollout_paths as cmp
from agile3d_torch.utils.ckpt import save_checkpoint
from tests.test_torch_model import SMALL
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_rollout_paths",
        os.path.join(ROOT, "tools", "compare_rollout_paths.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(seed: int):
    """Two scenes x two object counts, 9 rounds each: ``id scene obj
    clicks iou``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, (scene, n) in enumerate([("0000_00", 4), ("0001_00", 4),
                                    ("0000_00", 7)]):
        for r in range(9):
            rows.append([str(i), scene, str(n), str((n + r) / n),
                         repr(float(rng.random()))])
    return rows


def _write(path, rows):
    with open(path, "w") as f:
        f.write("".join(" ".join(r) + "\n" for r in rows))
    return str(path)


@pytest.mark.parametrize("case", ["equal", "planted", "under_tol", "short"])
def test_first_divergence_matches_jax(tmp_path, case):
    host = _rows(0)
    dev = [list(r) for r in host]
    if case == "planted":       # scene 0001_00, round 5
        dev[9 + 5][4] = repr(float(dev[9 + 5][4]) + 0.25)
    elif case == "under_tol":
        dev[3][4] = repr(float(dev[3][4]) + 5e-6)
    elif case == "short":       # the device trajectory of 0000_00 x 7 cut
        dev = dev[:-4]
    h = _write(tmp_path / "host.csv", host)
    d = _write(tmp_path / "dev.csv", dev)
    got = cmp.first_divergence(h, d)
    want = _jax_tool().first_divergence(h, d)
    assert got == want
    diverged = {k: v for k, v in got.items() if v[0] is not None}
    if case == "planted":
        assert diverged == {("0001_00", "4"): (5, 9)}
    else:
        assert diverged == {}


SMALL_CFG = Config(model=port_model_config(
    dataclasses.replace(SMALL, max_clicks=256)))


def test_compare_on_cpu_holds_the_evaluator_against_jax(tmp_path):
    out = str(tmp_path / "cmp")
    res = cmp.compare(out, groups="2x2x500,1x3x600", clicks=2, seed=42,
                      checkpoint=None, device="cpu", cfg=SMALL_CFG,
                      log=lambda *a: None)
    assert res["n_diverged"] == 0 and res["n_traj"] == 3
    assert set(res["first_divergence"].values()) == {None}
    with open(os.path.join(out, "host.csv")) as f:
        host_rows = f.read()
    with open(os.path.join(out, "dev.csv")) as f:
        assert f.read() == host_rows
    # rounds after round 0: one a click past round 0's (one an object),
    # then the last, per trajectory
    assert res["rounds"] == 2 * (2 * 2 - 2 + 1) + (3 * 2 - 3 + 1)
    merged = {}
    for gi in range(2):
        with open(os.path.join(out, f"group{gi}", "val_list.json")) as f:
            merged.update(json.load(f))
    want = JaxEvaluatorMO(merged, os.path.join(out, "host.csv"),
                          [0.5, 0.65, 0.8, 0.85, 0.9]).eval_results()
    same = lambda a: json.dumps({k: float(v) for k, v in a.items()},
                                sort_keys=True)
    assert same(res["host"]) == same(res["dev"]) == same(want)
    assert set(res["launches"]["dev"].values()) == {0}
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["n_traj"] == 3


def test_checkpoint_weights_are_used(tmp_path):
    """``--checkpoint`` loads the weights: a run from another seed's
    checkpoint writes other rows than the random-init run."""
    runs = {}
    for name, ckpt in (("init", None), ("ckpt", str(tmp_path / "c.pth"))):
        if ckpt:
            save_checkpoint(ckpt, init_agile3d(SMALL_CFG.model, seed=7,
                                               device="cpu"), 0)
        out = str(tmp_path / name)
        cmp.compare(out, groups="1x2x500", clicks=2, seed=42,
                    checkpoint=ckpt, device="cpu", cfg=SMALL_CFG,
                    log=lambda *a: None)
        with open(os.path.join(out, "host.csv")) as f:
            runs[name] = f.read()
    assert runs["init"] != runs["ckpt"]
