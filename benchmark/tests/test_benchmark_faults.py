"""The comparison that decides ``correct``, run whole on the CPU at a tiny
size past the look for a card: sound runs come out correct, a run with the
timed path broken underneath comes out not correct (once for each fault a
cell can have: an answer altered where it is produced, in training a
click of the rollout; in training a step that leaves its state unchanged,
and half of the batch left out with the mean taken over the rest), and
each cell's control, the reference in the program's place one precision
step below, reads above the sound run.

Slow for the CPU (a few minutes in all): the training cell runs full-width
steps.
"""

import pytest
import torch

from benchmark.tests.tiny import run_tiny, tiny_cell

SEED = 2 ** 31 + 99


def _checks(line):
    return {k: v["value"] for k, v in line["checks"].items()}


def _over(line):
    """The numbers that exceed their limits."""
    return [k for k, v in line["checks"].items()
            if not v["value"] <= v["limit"]]


@pytest.fixture(scope="module")
def sound():
    return {name: run_tiny(name, SEED, secs)[0] for name, secs in
            (("scannet40-serve", 3.0), ("scannet40-eval", 4.0),
             ("scannet40-train", 25.0))}


@pytest.mark.parametrize("name", ["scannet40-serve", "scannet40-eval",
                                  "scannet40-train"])
def test_sound_run_is_correct(sound, name):
    line = sound[name]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0


@pytest.mark.parametrize("name,number", [("scannet40-serve", "logit_err"),
                                         ("scannet40-eval", "logit_err"),
                                         ("scannet40-train", "loss_gap"),
                                         ("scannet40-train", "logit_err")])
def test_control_reads_above_the_sound_run(sound, name, number):
    line, _ = run_tiny(name, SEED, 2.0, control="lower")
    assert _checks(line)[number] >= 3 * _checks(sound[name])[number]


def test_served_answer_altered(monkeypatch):
    import agile3d_torch.interactive.server as server

    real = server.click_override_device

    def altered(pred, vox, obj):
        out = real(pred, vox, obj).clone()
        out[::7] = (out[::7] + 1) % 3
        return out

    monkeypatch.setattr(server, "click_override_device", altered)
    line, _ = run_tiny("scannet40-serve", SEED, 3.0)
    assert not line["correct"] and "logit_gap" in _over(line)


def test_eval_answer_altered(monkeypatch):
    import agile3d_torch.engine.device_eval as de

    real = de.mean_iou
    monkeypatch.setattr(de, "mean_iou",
                        lambda *a, **k: real(*a, **k) * 0.98)
    line, _ = run_tiny("scannet40-eval", SEED, 4.0)
    assert not line["correct"] and "logit_err" in _over(line)


def test_train_step_leaves_state_unchanged(monkeypatch):
    from agile3d_torch.engine.train import Optimizer

    def frozen(self):
        self.count += 1
        return torch.zeros(())

    monkeypatch.setattr(Optimizer, "step", frozen)
    line, _ = run_tiny("scannet40-train", SEED, 1.0)
    assert not line["correct"] and "change_gap" in _over(line)


def test_train_click_altered(monkeypatch):
    """A click of the training rollout moved to the next voxel where it is
    placed: the reference's simulator places it elsewhere."""
    import agile3d_torch.engine.device_train as dt

    real = dt.multi_cluster_clicks_device

    def altered(pred, labels, *a, **k):
        vox, obj, rank, sel = real(pred, labels, *a, **k)
        vox = vox.clone()
        vox[:, 0] = (vox[:, 0] + 1) % labels.shape[1]
        return vox, obj, rank, sel

    monkeypatch.setattr(dt, "multi_cluster_clicks_device", altered)
    line, _ = run_tiny("scannet40-train", SEED, 1.0)
    assert not line["correct"] and "loss_gap" in _over(line)


def test_train_half_batch_left_out(monkeypatch):
    import agile3d_torch.engine.train as tr

    real = tr.criterion_forward

    def half(all_masks, target, weights, vox_valid, cfg):
        h = max(1, target.shape[0] // 2)
        return real(all_masks[:, :h], target[:h], weights[:h],
                    vox_valid[:h], cfg)

    monkeypatch.setattr(tr, "criterion_forward", half)
    line, _ = run_tiny("scannet40-train", SEED, 1.0)
    # the loss of the half left in can lie near the whole batch's at this
    # size; the gradient it leaves reads apart
    assert not line["correct"] and {"loss_gap", "grad_gap"} & set(
        _over(line))


def test_tiny_cells_keep_the_published_widths():
    for name in ("scannet40-serve", "scannet40-train", "scannet40-eval"):
        cfg = tiny_cell(name).config
        assert cfg["decoder"]["hidden_dim"] == 128
        assert cfg["backbone"]["planes"] == [32, 64, 128, 256, 256, 128,
                                             96, 96]
