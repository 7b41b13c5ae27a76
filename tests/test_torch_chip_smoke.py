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
