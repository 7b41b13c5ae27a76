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
