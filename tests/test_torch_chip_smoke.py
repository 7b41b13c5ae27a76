"""``chip_smoke.py`` on a machine without a CUDA device: it must fail before
printing any result, from the repository and from a directory that holds
the script alone; and its bound counts the work the neighbour map needs."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    assert "FAILED" in out.stderr


def test_bound_counts_present_neighbours():
    nbr = torch.full((1000, 27), -1, dtype=torch.int32)
    nbr[:500, :10] = 0
    ms, by = chip_smoke.bound(nbr, 128, 96)
    flops = 2.0 * 5000 * 128 * 96
    nbytes = 4.0 * (1000 * 128 + 1000 * 27 + 27 * 128 * 96 + 1000 * 96)
    assert by == "bytes"
    np.testing.assert_allclose(
        ms, 1e3 * max(flops / chip_smoke.PEAK_BF16_FLOPS,
                      nbytes / chip_smoke.PEAK_HBM_BYTES))
    full = torch.zeros((100000, 27), dtype=torch.int32)
    assert chip_smoke.bound(full, 128, 96)[1] == "operations"


def test_replaced_tpu_kernels_are_found():
    assert chip_smoke.tpu_kernel("banded_conv.py", "_make_kernel") == \
        "agile3d_tpu/ops/banded_conv.py:181"
    assert chip_smoke.tpu_kernel("banded_stem.py", "_make_stem_kernel") == \
        "agile3d_tpu/ops/banded_stem.py:183"
    assert chip_smoke.tpu_kernel("banded_conv.py", "_make_dw_kernel") == \
        "agile3d_tpu/ops/banded_conv.py:280"
    # the TPU probes, in the repository's tools/
    assert chip_smoke.tpu_kernel("probe_banded_kernel.py",
                                 "make_banded_conv") == \
        "tools/probe_banded_kernel.py:99"
    assert chip_smoke.tpu_kernel("probe_vmem_gather.py", "gather_kernel") == \
        "tools/probe_vmem_gather.py:32"
    # the XLA fusion that the boundary-distance kernel stands in for
    assert chip_smoke.tpu_kernel("device_eval.py",
                                 "_boundary_distances_all") == \
        "agile3d_tpu/engine/device_eval.py:37"


@pytest.mark.parametrize("by", ["operations", "bytes"])
def test_summary_weights_shapes_by_their_launches(by):
    """The kernels line sums each shape's times over its launches per unit,
    names the kind of bound that holds the larger share, and leaves out the
    rows of other roles."""
    other = "bytes" if by == "operations" else "operations"
    common = dict(cin=4, cout=8)
    rows = [dict(role="dW", rows=10, count=3, max_abs_err=1e-6, ms=1.0,
                 plain_ms=5.0, bound_ms=0.25, bound_by=by, library_ms=2.0,
                 **common),
            dict(role="dW", rows=20, count=1, max_abs_err=3e-6, ms=2.0,
                 plain_ms=7.0, bound_ms=0.5, bound_by=other, library_ms=4.0,
                 **common),
            dict(role="eval", rows=30, count=8, max_abs_err=1.0, ms=9.0,
                 plain_ms=9.0, bound_ms=9.0, bound_by=other, library_ms=9.0,
                 **common)]
    s = chip_smoke._summary(rows, ("dW",))
    assert (s["ms"], s["plain_ms"], s["library_ms"]) == (5.0, 22.0, 10.0)
    assert s["bound_ms"] == 1.25 and s["bound_by"] == by
    assert s["max_abs_err"] == 3e-6
    assert s["shapes"] == "3x 10x4->8 (dW), 1x 20x4->8 (dW)"


def test_summary_without_a_library_call():
    """A kernel that no single PyTorch call matches has a null library
    time; a row may name its shape itself."""
    rows = [dict(role="eval round", shape="1x196608", count=1,
                 max_abs_err=0.0, ms=2.0, plain_ms=900.0, bound_ms=0.5,
                 bound_by="operations", library_ms=None),
            dict(role="ragged", shape="1x70001", count=0, max_abs_err=0.0,
                 ms=1.0, plain_ms=9.0, bound_ms=0.1, bound_by="operations",
                 library_ms=None)]
    s = chip_smoke._summary(rows, ("eval round",))
    assert s["library_ms"] is None and s["ms"] == 2.0
    assert s["shapes"] == "1x 1x196608 (eval round)"


def test_distance_cases_follow_the_batches(tmp_path):
    """The distance kernel's main-path inputs: each sample's raw
    coordinates in its rows, labelled objects as error clusters, pad rows
    invalid; then the three edge cases."""
    from agile3d_torch.config import Config
    from agile3d_torch.data.datasets import (
        InterMultiObjDataset,
        collate_scenes,
    )
    from agile3d_torch.data.synthetic import write_benchmark

    cfg = Config()
    scans, lst = write_benchmark(str(tmp_path), num_scenes=2, num_obj=3,
                                 seed=1, n_points=1500)
    ds = InterMultiObjDataset(scans, lst, cfg.model.voxel_size)
    batch = collate_scenes([ds[0], ds[1]], cfg.buckets)
    coords, cluster, valid = chip_smoke.rollout_inputs(batch)
    nv = [int((batch.sample_idx[i] >= 0).sum()) for i in range(2)]
    np.testing.assert_array_equal(coords[1, :nv[1]],
                                  batch.raw[nv[0]:nv[0] + nv[1]])
    assert (coords[0, nv[0]:] == 0).all() and not valid[0, nv[0]:].any()
    assert set(np.unique(cluster)) <= {-1, 11, 22, 33}
    cases = chip_smoke.distance_cases(batch, batch)
    assert [c[0] for c in cases] == [
        "eval round", "train round", "eval round, all rows",
        "train round, all rows", "ragged", "all invalid", "one cluster"]
    assert [c[1] for c in cases] == [1, 1, 0, 0, 0, 0, 0]
    # the main paths' call queries the error rows: here the objects
    np.testing.assert_array_equal(cases[0][5], cluster >= 0)
    assert cases[0][5].any() and not cases[0][5].all()
    assert all(c[5] is None for c in cases[2:])
    assert cases[4][2].shape == (1, 70001, 3) and not cases[5][4].any()
    assert (cases[6][3] == 0).all()



def test_scripted_session_clicks_each_object_in_turn():
    """The serving phase's session: the objects in turn, then the
    background, each click on a voxel of its object at a later time, the
    click sets growing by one."""
    labels = np.repeat(np.arange(4, dtype=np.int32), 50)
    sets = chip_smoke._scripted_clicks(labels, 9)
    assert len(sets) == 9
    order = [1, 2, 3, 0, 1, 2, 3, 0, 1]
    for t, (click_idx, times) in enumerate(sets):
        assert sum(len(v) for v in click_idx.values()) == t + 1
        assert sorted(x for v in times.values() for x in v) == \
            list(range(t + 1))
        for obj, rows in click_idx.items():
            assert (labels[rows] == int(obj)).all()
    last = sets[-1][0]
    assert [len(last[str(o)]) for o in (0, 1, 2, 3)] == \
        [order.count(o) for o in (0, 1, 2, 3)]
    assert len(set(last["1"])) == 3  # another voxel each time


def test_chunks_seen_counts_each_decoder_call_and_restores():
    from agile3d_torch.models.agile3d import Agile3D, ClickState
    from agile3d_torch.models.agile3d import SceneFeatures
    from tests.test_torch_model import SMALL
    from tests.test_torch_weights import port_model_config

    model = Agile3D(port_model_config(SMALL)).eval()
    n, c = 2048, SMALL.hidden_dim
    g = torch.Generator().manual_seed(0)
    scene = SceneFeatures(torch.randn((1, n, c), generator=g),
                          torch.randn((1, n, c), generator=g),
                          torch.ones((1, n), dtype=torch.bool),
                          torch.rand((1, n, 3), generator=g),
                          torch.zeros((1, 3)), torch.ones((1, 3)))
    clicks = ClickState(torch.tensor([[3, 9] + [-1] * 30]),
                        torch.tensor([[1, 0] + [0] * 30]),
                        torch.arange(32)[None])
    orig = Agile3D.forward_mask
    with torch.no_grad(), chip_smoke.chunks_seen() as seen:
        for _ in range(2):
            model.forward_mask(scene, clicks, torch.tensor([1]))
    assert seen == {0: 2} and Agile3D.forward_mask is orig


def test_kernels_line_lists_all_six_kernels():
    """Every kernel wrapper has its line entry, with the file it replaces,
    and main() drives the new phases and reports their launches."""
    import inspect

    from agile3d_torch.utils.profiling import kernel_wrappers

    meta = chip_smoke.kernel_meta()
    assert sorted(meta) == sorted(kernel_wrappers()) == sorted([
        "banded_conv", "banded_conv_dw", "banded_stem", "banded_window_conv",
        "smem_row_gather", "boundary_distances_all"])
    for source, replaces, roles, unit in meta.values():
        assert os.path.exists(os.path.join(ROOT, source))
        assert ":" in replaces and roles and unit
    main = inspect.getsource(chip_smoke.main)
    for phase in ("phase_variants", "phase_oversize", "phase_memory",
                  "phase_benches", "phase_main_path", "phase_kernels"):
        assert callable(getattr(chip_smoke, phase))
        assert f"{phase}(" in main
    for path in ('"variants"', '"eval_oversize"', '"bench"',
                 '"bench_train"'):
        assert path in main


def test_main_path_passes_the_reference_block_at_its_defaults():
    from agile3d_torch import eval_multi_obj
    from agile3d_torch.cli import model_config_from_args
    from agile3d_torch.config import ModelConfig

    args = eval_multi_obj.get_args_parser().parse_args(
        ["--scan_folder", "s", "--val_list", "v"]
        + chip_smoke.REFERENCE_BLOCK)
    cfg = model_config_from_args(args, max_clicks=args.max_clicks_budget,
                                 decoder_dtype=args.decoder_dtype)
    assert cfg == ModelConfig()
    assert "--max_clicks_budget" in chip_smoke.REFERENCE_BLOCK
    assert "--decoder_dtype" in chip_smoke.REFERENCE_BLOCK


def test_kernel_cases_hold_the_variants_shapes():
    """B1 forward at the variants' four shapes on both finest eval levels,
    dX and B3 at two of them on the training reference batch's level 0."""
    from types import SimpleNamespace

    level = lambda n: SimpleNamespace(rows=n)
    pyr = lambda *ns: SimpleNamespace(levels=[level(n) for n in ns])
    cases = chip_smoke.kernel_cases(pyr(196608, 49152), pyr(524288, 98304),
                                    pyr(65536, 16384))
    variant = [(name, role, lv.rows, cin, cout)
               for name, role, lv, cin, cout, _ in cases
               if role.startswith("variant")]
    fwd = [(n, ci, co) for _, role, n, ci, co in variant
           if role == "variant forward"]
    assert fwd == [(n, ci, co) for n in (196608, 49152)
                   for ci, co in ((416, 384), (384, 384), (256, 256),
                                  (96, 64))]
    assert [(name, role, n, ci, co) for name, role, n, ci, co in variant
            if role != "variant forward"] == [
        ("banded_conv", "variant dX", 65536, 384, 416),
        ("banded_conv_dw", "variant dW", 65536, 416, 384),
        ("banded_conv", "variant dX", 65536, 256, 256),
        ("banded_conv_dw", "variant dW", 65536, 256, 256)]


def test_kernel_cases_hold_the_bf16_shapes():
    """Every main-path shape (B1 and B2 at the eval forward's, B1 forward,
    dX and B3 at the training step's) again with bf16 operands, with the
    same launches per unit; the variants' shapes are not repeated."""
    from types import SimpleNamespace

    level = lambda n: SimpleNamespace(rows=n)
    pyr = lambda *ns: SimpleNamespace(levels=[level(n) for n in ns])
    cases = chip_smoke.kernel_cases(pyr(196608, 49152), pyr(524288, 98304),
                                    pyr(65536, 16384))
    key = lambda c: (c[0], c[2].rows, c[3], c[4], c[5])
    main = [c for c in cases if c[1] in ("eval", "train forward", "dX", "dW")]
    bf16 = [c for c in cases if c[1].startswith("bf16 ")]
    assert [key(c) for c in bf16] == [key(c) for c in main]
    assert [c[1] for c in bf16] == [f"bf16 {c[1]}" for c in main]
    assert len(bf16) == 17 and sum(c[0] == "banded_stem" for c in bf16) == 1
    assert sum(c[5] for c in bf16 if c[1] == "bf16 eval"
               and c[0] == "banded_conv") == 8


def test_bound_counts_bf16_operands_in_two_bytes():
    nbr = torch.full((1000, 27), -1, dtype=torch.int32)
    nbr[:500, :10] = 0
    ms, by = chip_smoke.bound(nbr, 128, 96, x_bytes=2, w_bytes=2, y_bytes=2)
    nbytes = (2.0 * 1000 * 128 + 4.0 * 1000 * 27 + 2.0 * 27 * 128 * 96
              + 2.0 * 1000 * 96)
    assert by == "bytes"
    np.testing.assert_allclose(ms, 1e3 * nbytes / chip_smoke.PEAK_HBM_BYTES)
    assert ms < chip_smoke.bound(nbr, 128, 96)[0]


def test_main_drives_the_bf16_dropout_and_resume_phases():
    """main() runs the tenth slice's phases and reports their launches as
    paths of their own beside the earlier paths."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    for phase in ("phase_bf16_backbone", "phase_dropout", "phase_resume",
                  "phase_train_reference"):
        assert callable(getattr(chip_smoke, phase))
        assert f"{phase}(" in main
    for path in ('"bf16_backbone"', '"dropout"', '"resume"', '"train"',
                 '"eval"', '"single"', '"serve"'):
        assert path in main
    assert '"bf16_shapes"' in main


def test_main_runs_the_tool_phases_and_times_every_phase():
    """main() drives every tool's phase and reports its launches; each
    phase is followed by its own lap in the phase_seconds line."""
    import inspect
    import re

    main = inspect.getsource(chip_smoke.main)
    for phase in ("phase_regime", "phase_stress", "phase_rollout_paths",
                  "phase_sp_hbm", "phase_dp_scaling"):
        assert callable(getattr(chip_smoke, phase))
        assert f"{phase}(" in main
    for path in ('"sp_hbm"', '"dp_scaling"', '"regime"', '"stress"',
                 '"rollout_paths"'):
        assert path in main
    calls = re.findall(r"\bphase_(\w+)\(", main)
    laps = re.findall(r'\blap\("(\w+)"\)', main)
    assert len(laps) == len(set(laps)) and len(laps) >= len(set(calls))
    assert "phase_seconds" in main
    assert chip_smoke.SP_HBM_ARGS[chip_smoke.SP_HBM_ARGS.index("--sp") + 1] == "2"
    assert chip_smoke.DP_SCALING_WIDTHS == (1, 2)
