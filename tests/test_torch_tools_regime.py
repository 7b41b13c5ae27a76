"""The port's training-regime tools (``agile3d_torch/tools/train_regime.py``,
``train_evidence.py``) against the repository's JAX tools on the CPU: the
same data (seeds 11 and 999), the same ``main`` flags but the entry point,
the same curves from the same val CSVs; then the port's tool end to end at
the reduced width (a 2-epoch run through the LR drop, a piece cut by
``--max_seconds`` or after an epoch, a validation that a cut lost
recorded on resume)."""

import filecmp
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from agile3d_torch.tools import train_evidence, train_regime

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# main's flags at the reduced width: 1 click an object, a narrow decoder
SMALL_MAIN = ["--max_num_clicks", "1", "--hidden_dim", "32",
              "--dim_feedforward", "64", "--num_heads", "2"]
SIZES = ["--scenes", "2", "--val_scenes", "3", "--n_points", "300",
         "--num_obj", "2"]
# the port's runs: one step an epoch, one val scene
RUN_SIZES = ["--scenes", "1", "--val_scenes", "1", "--n_points", "200",
             "--num_obj", "1"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FakeChild:
    """``subprocess.Popen`` for the JAX tool: records the command, writes
    ``csvs`` ({epoch: text}) where ``main.py`` writes its val CSVs, and
    exits 0."""
    cmds = []
    csvs = {}

    def __init__(self, cmd, **kwargs):
        _FakeChild.cmds.append(cmd)
        out = cmd[cmd.index("--output_dir") + 1]
        val_dir = os.path.join(out, "2026-01-01-00-00-00", "valResults")
        os.makedirs(val_dir, exist_ok=True)
        for epoch, text in _FakeChild.csvs.items():
            with open(os.path.join(val_dir,
                                   f"val_results_epoch_{epoch}.csv"),
                      "w") as f:
                f.write(text)

    def wait(self, timeout=None):
        return 0


def _val_csv(val_list: str, seed: int, clicks: int = 20) -> str:
    """Rows of a multi-object validation (``id scene obj clicks iou``) for
    every scene of ``val_list``, IoUs rising with the clicks."""
    rng = np.random.default_rng(seed)
    with open(val_list) as f:
        names = list(json.load(f))
    rows = []
    for i, key in enumerate(names):
        scene, num_obj = key.split("_obj_")
        n = int(num_obj)
        for current in range(0, n * clicks + 1):
            iou = min(1.0, 0.05 * current / n + 0.3 * rng.random())
            rows.append(f"{i} {scene.replace('scene', '')} {n} "
                        f"{current / n} {iou}")
    return "\n".join(rows) + "\n"


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX tool's main with a fake child at the reduced sizes: its data,
    command and summary (curves from two planted val CSVs)."""
    work = str(tmp_path_factory.mktemp("jax_regime"))
    mod = _jax_tool("train_regime")
    list_v = os.path.join(work, "val", "val_list.json")
    _FakeChild.cmds = []
    _FakeChild.csvs = {}
    orig_popen, orig_argv = mod.subprocess.Popen, sys.argv
    mod.subprocess.Popen = _FakeChild
    sys.argv = ["train_regime.py", work, "--epochs", "20"] + SIZES
    try:
        # write the data first (the fake child reads no list), then plant
        # the CSVs and run the tool for real
        mod.main()
        _FakeChild.csvs = {9: _val_csv(list_v, 0), 19: _val_csv(list_v, 1)}
        _FakeChild.cmds = []
        mod.main()
    finally:
        mod.subprocess.Popen, sys.argv = orig_popen, orig_argv
    with open(os.path.join(work, "summary.json")) as f:
        summary = json.load(f)
    return work, _FakeChild.cmds[0], summary


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_data_writer_matches_jax(jax_run, tmp_path):
    jax_work = jax_run[0]
    scans, list_t, list_v = train_regime.write_data(
        str(tmp_path), scenes=2, val_scenes=3, n_points=300, num_obj=2)
    for sub in ("train", "val"):
        mine, theirs = (_tree(os.path.join(w, sub))
                        for w in (str(tmp_path), jax_work))
        assert mine.keys() == theirs.keys()
        for rel in mine:
            assert filecmp.cmp(mine[rel], theirs[rel], shallow=False), rel
    # a val scan whose name no train scan has is linked in by absolute
    # path; the others keep the train scan of their name (as in JAX)
    linked = [f for f in sorted(os.listdir(scans))
              if os.path.islink(os.path.join(scans, f))]
    assert linked == ["scene0002_00.ply"]
    assert os.path.isabs(os.readlink(os.path.join(scans, linked[0])))
    assert list_t == os.path.join(str(tmp_path), "train", "val_list.json")


def test_command_matches_jax_but_the_entry_point(jax_run):
    jax_work, jax_cmd, _ = jax_run
    w = lambda *p: os.path.join(jax_work, *p)
    base = dict(epochs=20, lr_drop=train_regime.lr_drop_epoch(20, 1000 / 1100),
                val_epochs=10)
    cmd = train_regime.build_command(
        w("train", "scans"), w("train", "val_list.json"),
        w("val", "val_list.json"), w("out"), **base)
    assert jax_cmd[:2] == [sys.executable, "main.py"]
    assert cmd[:3] == [sys.executable, "-m", "agile3d_torch.main"]
    assert cmd[3:] == jax_cmd[2:]
    resumed = train_regime.build_command(
        w("train", "scans"), w("train", "val_list.json"),
        w("val", "val_list.json"), w("out"), resume="ck.pth", **base)
    assert resumed[3:] == jax_cmd[2:] + ["--resume", "ck.pth"]


def test_evidence_command_matches_jax(tmp_path, monkeypatch):
    """train_evidence: the JAX tool's flags for 30 and for 7 epochs (its
    data writer stubbed out: 72 scenes of 60,000 points)."""
    mod = _jax_tool("train_evidence")
    calls = []
    stub = lambda d, **k: (os.path.join(d, "scans"),
                           os.path.join(d, "val_list.json"))
    monkeypatch.setattr(mod, "write_benchmark", stub)
    monkeypatch.setattr(mod.subprocess, "call",
                        lambda cmd, env=None: calls.append(cmd) or 0)
    for epochs in (30, 7):
        work = str(tmp_path / str(epochs))
        os.makedirs(os.path.join(work, "val", "scans"))
        monkeypatch.setattr(sys, "argv", ["train_evidence.py", work,
                                          str(epochs)])
        mod.main()
        w = lambda *p: os.path.join(work, *p)
        cmd = train_evidence.build_command(
            w("train", "scans"), w("train", "val_list.json"),
            w("val", "val_list.json"), w("out"), epochs)
        assert calls[-1][:2] == [sys.executable, "main.py"]
        assert cmd[3:] == calls[-1][2:]


def test_curve_reader_matches_jax(jax_run):
    jax_work, _, summary = jax_run
    curves = train_regime.read_curves(os.path.join(jax_work, "out"),
                                      os.path.join(jax_work, "val",
                                                   "val_list.json"))
    want = {int(e): c for e, c in summary["val_curves"].items()}
    assert sorted(curves) == [9, 19] == sorted(want)
    assert curves == want
    # the planted rows reach every threshold within the budget
    assert all(np.isfinite(v) for c in curves.values() for v in c.values())


def test_progress_lines_are_read():
    lines = ["number of params: 1", "epoch 3 lr 0.0001",
             "Epoch: [3] [0/1] eta: 0:00:00 loss: 1.0",
             'epoch 3 done: steps 8 kernel launches {"banded_conv": 24}',
             "epoch 4 lr 1e-05"]
    assert train_regime.read_progress(lines) == {
        "lr_by_epoch": {3: 1e-4, 4: 1e-5}, "epochs_done": [3], "steps": 8,
        "launches": {"banded_conv": 24}}


def test_cut_piece_keeps_the_epochs_it_finished(tmp_path, jax_run):
    """A child that finishes epoch 0 (its log lines and its val CSV) and
    then hangs: TERM at the bound, and the summary still holds epoch 0."""
    jax_work = jax_run[0]
    list_v = os.path.join(jax_work, "val", "val_list.json")
    work = str(tmp_path)
    val_dir = os.path.join(work, "out", "run0", "valResults")
    script = (
        "import os, shutil, time\n"
        "print('epoch 0 lr 0.0001')\n"
        "print('epoch 0 done: steps 5 kernel launches {\"banded_conv\": 3}')\n"
        f"os.makedirs({val_dir!r})\n"
        f"open(os.path.join({val_dir!r}, 'val_results_epoch_0.csv'), 'w')"
        f".write({_val_csv(list_v, 2)!r})\n"
        "print('epoch 1 lr 0.0001', flush=True)\n"
        "time.sleep(120)\n")
    summary = train_regime.run_pieces(
        work, [sys.executable, "-c", script], max_seconds=3, resume="",
        meta={"epochs": 2}, val_list=list_v, device="cpu",
        log=lambda *a: None)
    (piece,) = summary["pieces"]
    assert piece["cut"] and piece["exit"] != 0
    assert piece["epochs_done"] == [0] and summary["steps"] == 5
    assert summary["lr_by_epoch"] == {0: 1e-4, 1: 1e-4}
    assert summary["launches"] == {"banded_conv": 3}
    assert list(summary["val_curves"]) == [0] and not summary["in_pieces"]
    with open(os.path.join(work, "summary.json")) as f:
        assert json.load(f)["epochs"] == 2


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's tool end to end on the CPU: 2 epochs of one step, the LR
    dropped at epoch 1, validation every epoch."""
    work = str(tmp_path_factory.mktemp("port_regime"))
    argv = [work, "--epochs", "2", "--lr_drop_frac", "0.5",
            "--val_epochs", "1", "--device", "cpu"] + RUN_SIZES
    summary = train_regime.main(argv + ["--"] + SMALL_MAIN,
                                log=lambda *a: None)
    return work, argv, summary


def test_two_epoch_run_through_the_drop(port_run):
    work, _, summary = port_run
    (piece,) = summary["pieces"]
    assert summary["exit"] == 0 and not piece["cut"]
    assert piece["epochs_done"] == [0, 1] and summary["steps"] == 2
    assert summary["lr_drop"] == 1
    assert summary["lr_by_epoch"] == {0: 1e-4, 1: 1e-5}
    assert sorted(summary["val_curves"]) == [0, 1]
    assert summary["device"] == "cpu"
    assert train_regime.last_checkpoint(work).endswith("checkpoint.pth")
    # the CPU runs the plain versions: no kernel launch
    assert set(summary["launches"].values()) == {0}


def _copy(work, dst):
    shutil.copytree(work, dst, symlinks=True)
    return str(dst)


def test_resume_records_a_lost_validation(port_run, tmp_path):
    """A cut between epoch 1's checkpoint and the end of its validation
    (simulated: its CSV removed, as ``main`` writes a CSV only when it is
    whole): the resumed piece starts after the checkpoint's epoch, and the
    summary lists epoch 1's validation as lost."""
    src, argv, _ = port_run
    work = _copy(src, tmp_path / "w")
    ckpt = train_regime.last_checkpoint(work)
    os.remove(os.path.join(os.path.dirname(ckpt), "valResults",
                           "val_results_epoch_1.csv"))
    argv = [work] + argv[1:]
    summary = train_regime.main(argv + ["--resume", ckpt, "--"] + SMALL_MAIN,
                                log=lambda *a: None)
    piece = summary["pieces"][-1]
    assert piece["exit"] == 0 and piece["resumed_from"]["epoch"] == 1
    assert piece["epochs_done"] == [] and summary["in_pieces"]
    assert summary["lost_validations"] == [1]
    assert sorted(summary["val_curves"]) == [0]


def test_stop_after_epoch_cuts_after_that_epoch(tmp_path):
    """A child that logs epochs 0 and 1 done and then hangs is cut once
    epoch 1's line is in the log, long before the wall-clock bound; the
    lines of an earlier piece in the same log do not cut it."""
    work = str(tmp_path)
    with open(os.path.join(work, "train_log.txt"), "w") as f:
        f.write('epoch 1 done: steps 9 kernel launches {}\n')
    script = (
        "import time\n"
        "print('epoch 0 done: steps 1 kernel launches {}', flush=True)\n"
        "time.sleep(1)\n"
        "print('epoch 1 done: steps 2 kernel launches {}', flush=True)\n"
        "time.sleep(120)\n")
    summary = train_regime.run_pieces(
        work, [sys.executable, "-c", script], max_seconds=100, resume="",
        meta={"epochs": 4, "val_epochs": 2}, val_list="",
        device="cpu", log=lambda *a: None, stop_after_epoch=1)
    (piece,) = summary["pieces"]
    assert piece["cut"] and piece["exit"] != 0 and piece["wall_s"] < 30
    assert piece["epochs_done"] == [0, 1] and summary["steps"] == 2
    assert summary["lost_validations"] == [] and summary["val_curves"] == {}


def test_resumed_piece_cut_by_the_bound(port_run, tmp_path):
    """A resumed piece cut before it finishes an epoch: two pieces, the
    second cut, and the first piece's curves kept."""
    src, argv, first = port_run
    work = _copy(src, tmp_path / "w")
    ckpt = train_regime.last_checkpoint(work)
    argv = [work] + argv[1:]
    argv[argv.index("--epochs") + 1] = "3"
    summary = train_regime.main(
        argv + ["--resume", ckpt, "--max_seconds", "2", "--"] + SMALL_MAIN,
        log=lambda *a: None)
    pieces = summary["pieces"]
    assert len(pieces) == 2 and summary["in_pieces"]
    assert pieces[1]["cut"] and pieces[1]["resume"] == ckpt
    assert pieces[1]["epochs_done"] == [] and summary["lost_validations"] == []
    same = lambda c: json.dumps(c, sort_keys=True)   # NoC@k is NaN here
    assert same(summary["val_curves"]) == same(first["val_curves"])
    assert summary["steps"] == 2


def test_tools_import_no_jax():
    code = ("import sys; import agile3d_torch.tools.train_regime, "
            "agile3d_torch.tools.train_evidence, "
            "agile3d_torch.tools.stress_kitti, "
            "agile3d_torch.tools.compare_rollout_paths; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'agile3d_tpu'))]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
