"""One short run of a cell on the card through the command itself: the
result line's keys, a device that names the card, and ``correct``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.tests.tiny import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    return torch.cuda.get_device_name(0)


def test_serve_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scannet40-serve",
         "--seed", str(2 ** 31 + 5), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert line["device"]["kind"] == card
    assert line["correct"], line["checks"]


def test_refuses_without_the_cards_it_needs(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scannet40-serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
