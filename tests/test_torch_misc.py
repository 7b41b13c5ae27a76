"""The port's metric logging (``agile3d_torch/utils/misc.py``) against the
JAX package's: the same values give the same meters, averages and log
lines (exactly: both compute in Python floats), with the clock pinned."""

import itertools

import pytest

from agile3d_torch.utils import misc as pmisc
from agile3d_tpu.utils import misc as jmisc

VALUES = [
    {"loss": 3.25, "grad_norm": 118.5, "mIoU": 0.125},
    {"loss": 2.5, "grad_norm": 97.25, "mIoU": 0.25, "loss_bce": 0.75},
    {"loss": 2.0, "grad_norm": 80.0, "mIoU": 0.5, "loss_bce": 0.5},
] * 9   # 27 updates: the 20-value window drops the first ones


def _fill(module):
    logger = module.MetricLogger()
    for row in VALUES:
        logger.update(**row)
    return logger


def test_meters_and_line_match_jax():
    got, want = _fill(pmisc), _fill(jmisc)
    assert str(got) == str(want)
    assert list(got.meters) == list(want.meters)
    for k, m in want.meters.items():
        p = got.meters[k]
        assert (p.count, p.total, p.median, p.avg, p.value, p.global_avg) == (
            m.count, m.total, m.median, m.avg, m.value, m.global_avg), k
    assert got.loss.global_avg == sum(r["loss"] for r in VALUES) / len(VALUES)
    with pytest.raises(AttributeError):
        got.not_a_meter


def test_smoothed_value_window_and_weights_match_jax():
    got, want = pmisc.SmoothedValue(window_size=3), jmisc.SmoothedValue(3)
    for v, n in ((1.0, 1), (4.0, 2), (2.0, 1), (8.0, 3)):
        got.update(v, n)
        want.update(v, n)
        assert str(got) == str(want)
    assert list(got.deque) == [4.0, 2.0, 8.0]
    assert got.global_avg == (1 + 8 + 2 + 24) / 7


@pytest.mark.parametrize("sized", [True, False], ids=["len", "iterator"])
def test_log_every_lines_match_jax(monkeypatch, sized):
    lines = {}
    for name, module in (("port", pmisc), ("jax", jmisc)):
        clock = itertools.count(1000.0, 0.75)
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
        out = []
        logger = module.MetricLogger(log=out.append)
        items = list(range(23)) if sized else iter(range(23))
        for i in logger.log_every(items, 5, "Epoch: [3]"):
            logger.update(loss=10.0 / (i + 1), mIoU=i / 23)
        lines[name] = out
    assert lines["port"] == lines["jax"]
    assert lines["port"][-1].startswith("Epoch: [3] Total time: ")
    assert len(lines["port"]) == (6 if sized else 5) + 1


def test_reduce_dict_is_the_identity_in_one_process():
    d = {"loss": 1.5, "loss_dice": 0.25}
    got = pmisc.reduce_dict(d)
    assert got == jmisc.reduce_dict(d) == d and got is not d
    logger = _fill(pmisc)
    before = str(logger)
    logger.synchronize_between_processes()
    assert str(logger) == before


def test_setup_wandb_follows_jax(tmp_path, monkeypatch):
    """A key in the environment, a cached key, and none at all (no TTY)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin.isatty", lambda: False)
    monkeypatch.setenv("WANDB_API_KEY", "k0")
    assert pmisc.setup_wandb() is jmisc.setup_wandb() is True
    monkeypatch.delenv("WANDB_API_KEY")
    assert pmisc.setup_wandb() is jmisc.setup_wandb() is False
    import getpass

    keys = tmp_path / "wandb_keys"
    keys.mkdir()
    (keys / f"{getpass.getuser()}_wandb.key").write_text("k1\n")
    assert pmisc.setup_wandb() is True
    assert pmisc.os.environ["WANDB_API_KEY"] == "k1"


def test_reductions_over_a_two_rank_group():
    """In a group of two processes (the data-parallel ranks), the meters'
    (count, total) and ``reduce_dict``'s values are summed over the ranks
    (averaged by ``reduce_dict`` by default), the same on both, as the JAX
    package's ``_all_reduce_sum`` sums them over its processes."""
    from agile3d_torch.parallel.mesh import spawn
    from tests import torch_parallel_ranks as ranks

    got = spawn(ranks.misc_reduce, 2, device="cpu")
    assert got[0] == got[1]
    g = got[0]
    assert (g["count"], g["total"]) == (5, 0 + 1 + 10 + 11 + 12)
    assert g["global_avg"] == 34 / 5
    assert g["reduced"] == {"a": 1.0, "b": 1.5}
    assert list(g["reduced"]) == ["a", "b"]
    assert g["summed"] == {"b": 3.0}
