"""The port's single-object (InterObject3D) protocol against the JAX
package's: the dataset and its collation on the same PLY files (binarised
labels, the ``--crop`` scans, one object counted from the ``str`` tag),
the host rollout's rows (schedule equal, IoU at atol 1e-4), the port's
device rollout against its host loop (rows equal, IoU at atol 1e-5, the
same click buckets round by round), the entry point end to end on the CPU,
``EvaluatorSO`` and AP (equal to JAX's on CSVs written here, with ties and
objects that never reach 0.5) and ``compute_ap``'s printed table."""

import contextlib
import dataclasses
import io
import os
import random
import types

import numpy as np
import pytest
import torch

import compute_ap as jax_compute_ap
from agile3d_torch import compute_ap as port_compute_ap
from agile3d_torch import eval_single_obj
from agile3d_torch.cli import device_arg
from agile3d_torch.config import Config as PortConfig
from agile3d_torch.data import datasets as pdata
from agile3d_torch.engine import device_eval as pdev
from agile3d_torch.engine import eval as peval
from agile3d_torch.evaluation import ap as pap
from agile3d_torch.evaluation.evaluators import EvaluatorSO as PortEvaluatorSO
from agile3d_tpu.config import Config
from agile3d_tpu.data import datasets as jdata
from agile3d_tpu.data.ply import read_ply, write_ply
from agile3d_tpu.engine import eval as jeval
from agile3d_tpu.evaluation import ap as jap
from agile3d_tpu.evaluation.evaluators import EvaluatorSO
from tests.synthetic import write_benchmark
from tests.test_torch_model import SMALL, port_model, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

MAX_NUM_CLICKS = 4
ROLLOUT_SEED = 13
OBJECTS = np.array([["scene0000_00", "1"], ["scene0000_00", "2"],
                    ["scene0000_00", "3"]])


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("single")
    scans, _ = write_benchmark(str(root), num_scenes=1, num_obj=3, seed=11,
                               n_points=1500)
    # a pre-cropped scan of object 2: its points and the nearest half of
    # the rest, labels binary
    pc = read_ply(os.path.join(scans, "scene0000_00.ply"))
    keep = (pc["label"] == 2) | (np.arange(len(pc["label"])) % 2 == 0)
    crop = {k: v[keep] for k, v in pc.items()}
    crop["label"] = (crop["label"] == 2).astype(np.int32)
    os.makedirs(os.path.join(scans, "scene0000_00"))
    write_ply(os.path.join(scans, "scene0000_00", "scene0000_00_crop_2.ply"),
              crop)
    return root, scans


@pytest.mark.parametrize("crop", [False, True])
def test_dataset_and_collate_match_jax(bench, crop):
    _, scans = bench
    objects = OBJECTS[1:2] if crop else OBJECTS
    jds = jdata.build_dataset("val", "single_obj", scan_folder=scans,
                              scene_list=objects, crop=crop)
    pds = pdata.build_dataset("val", "single_obj", scan_folder=scans,
                              scene_list=objects, crop=crop)
    assert len(pds) == len(jds) == len(objects)
    for i in range(len(objects)):
        j, p = jds[i], pds[i]
        for f in jdata.SceneSample._fields:
            if f == "click_idx":
                assert p.click_idx == j.click_idx == {}
                continue
            a, b = getattr(p, f), getattr(j, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, f
        assert set(np.unique(p.labels)) <= {0, 1} and p.num_obj == \
            objects[i, 1]
        jb, pb = jdata.collate_scenes([j]), pdata.collate_scenes([p])
        assert list(pb.num_obj) == list(jb.num_obj) == [1]
        assert pb.obj_tags == jb.obj_tags == [objects[i, 1]]
        for f in ("feats", "raw", "sample_idx", "labels"):
            np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f))


def test_collate_counts_objects_only_for_str_tags():
    """A multi-object sample keeps its int count; a single-object sample's
    tag is an object id, so its count comes from its labels."""
    rng = np.random.default_rng(0)
    vox = rng.integers(0, 50, (200, 3)).astype(np.int32)
    vox = np.unique(vox, axis=0)
    n = len(vox)
    base = dict(vox_coords=vox, raw_coords=vox.astype(np.float32),
                feats=np.zeros((n, 3), np.float32),
                labels_full=np.zeros(n, np.int32),
                inverse_map=np.arange(n), click_idx={}, scene_name="s")
    labels = np.where(np.arange(n) < n // 2, 0, 1).astype(np.int32)
    got = pdata.collate_scenes([
        pdata.SceneSample(labels=labels, num_obj="7", **base),
        pdata.SceneSample(labels=labels, num_obj=3, **base)])
    assert list(got.num_obj) == [1, 3]
    assert got.obj_tags == ["7", 3]


@pytest.fixture(scope="module")
def rollouts(bench):
    root, scans = bench
    sd, params, buffers, bn_state = randomized_weights(
        SMALL, 42, np.random.default_rng(0))
    jcfg = Config(model=SMALL)
    jengine = jeval.InteractiveEngine(jcfg)
    pcfg = PortConfig(model=port_model_config(SMALL))
    engine = peval.InteractiveEngine(pcfg, port_model(SMALL, sd),
                                     device="cpu")
    jds = jdata.InterSingleObjDataset(scans, OBJECTS, 0.05)
    pds = pdata.InterSingleObjDataset(scans, OBJECTS, 0.05)
    out = {"jax": [], "host": [], "device": [], "batches": []}
    jrng, hrng, drng = (random.Random(ROLLOUT_SEED) for _ in range(3))
    for i in range(len(OBJECTS)):
        kw = dict(instance_id=i, max_num_clicks=MAX_NUM_CLICKS, mode="single")
        jbatch = jdata.collate_scenes([jds[i]], jcfg.buckets)
        out["jax"] += jeval.evaluate_scene(jengine, params, buffers, bn_state,
                                           jbatch, rng=jrng, **kw)
        pbatch = pdata.collate_scenes([pds[i]], pcfg.buckets)
        out["batches"].append(pbatch)
        out["host"] += peval.evaluate_scene(engine, pbatch, rng=hrng, **kw)
        out["device"] += pdev.evaluate_scene_device(engine, pbatch, rng=drng,
                                                    **kw)
    return dict(out, engine=engine, root=root, scans=scans)


def test_host_rollout_matches_jax(rollouts):
    got = [r.split(" ") for r in rollouts["host"]]
    want = [r.split(" ") for r in rollouts["jax"]]
    # 3 objects x rounds at 0..4 clicks, absolute counts
    assert len(want) == len(OBJECTS) * (MAX_NUM_CLICKS + 1)
    assert [w[3] for w in want[:MAX_NUM_CLICKS + 1]] == \
        [str(k) for k in range(MAX_NUM_CLICKS + 1)]
    assert [g[:4] for g in got] == [w[:4] for w in want]
    np.testing.assert_allclose([float(g[4]) for g in got],
                               [float(w[4]) for w in want], rtol=0, atol=1e-4)


def test_device_rollout_matches_host_loop(rollouts):
    host = [r.split(" ") for r in rollouts["host"]]
    dev = [r.split(" ") for r in rollouts["device"]]
    assert [d[:4] for d in dev] == [h[:4] for h in host]
    np.testing.assert_allclose([float(d[4]) for d in dev],
                               [float(h[4]) for h in host], rtol=0, atol=1e-5)


def test_device_rollout_sees_the_host_loops_click_buckets(rollouts,
                                                          monkeypatch):
    """With a bucket ladder that the 4-click budget crosses twice, both
    rollouts hand the decoder the same click-table width in every round."""
    engine = rollouts["engine"]
    batch = rollouts["batches"][1]
    monkeypatch.setattr(engine, "CLICK_BUCKETS", (1, 2, 4))
    widths = []
    real = engine.model.forward_mask

    def spy(scene, clicks, num_obj):
        widths.append(clicks.vox.shape[1])
        return real(scene, clicks, num_obj)

    monkeypatch.setattr(engine.model, "forward_mask", spy)
    rows = {}
    for name, fn in (("host", peval.evaluate_scene),
                     ("device", pdev.evaluate_scene_device)):
        widths.clear()
        rows[name] = [r.split(" ") for r in fn(
            engine, batch, instance_id=1, rng=random.Random(ROLLOUT_SEED),
            max_num_clicks=MAX_NUM_CLICKS, mode="single")]
        rows[name + "_widths"] = list(widths)
    assert rows["host_widths"] == [1, 2, 4, 4]
    assert rows["device_widths"] == rows["host_widths"]
    assert [d[:4] for d in rows["device"]] == [h[:4] for h in rows["host"]]
    np.testing.assert_allclose([float(d[4]) for d in rows["device"]],
                               [float(h[4]) for h in rows["host"]],
                               rtol=0, atol=1e-5)


def test_entry_point_on_cpu(rollouts, monkeypatch, tmp_path):
    """``python -m agile3d_torch.eval_single_obj --device cpu`` at the
    reduced width (the device rollout, then --host_rollout: the same rows),
    then ``EvaluatorSO`` against JAX's on the CSV it wrote, whole and per
    class."""
    build = eval_single_obj.build_config
    monkeypatch.setattr(eval_single_obj, "build_config", lambda args: (
        dataclasses.replace(build(args), model=dataclasses.replace(
            port_model_config(SMALL), max_clicks=64))))
    objects = str(tmp_path / "objects.npy")
    np.save(objects, OBJECTS)
    classes = str(tmp_path / "classes.txt")
    np.savetxt(classes, np.array(["chair", "table", "chair"]), fmt="%s")
    rows = {}
    for name, extra in (("device", []), ("host", ["--host_rollout"])):
        out_dir = str(tmp_path / name)
        args = eval_single_obj.get_args_parser().parse_args([
            "--scan_folder", rollouts["scans"], "--val_list", objects,
            "--val_list_classes", classes, "--max_num_clicks", "3",
            "--output_dir", out_dir, "--device", "cpu", "--seed", "0",
            *extra])
        assert args.decoder_dtype == "float32" and args.dataset == "scannet40"
        logged = []
        results = eval_single_obj.main(args, log=logged.append)
        assert results in logged and np.isfinite(results["IoU@1"])
        csv = os.path.join(out_dir, "val_results_single.csv")
        rows[name] = [r.split(" ") for r in open(csv).read().split("\n") if r]
    assert len(rows["device"]) == 3 * 4
    assert [r[:4] for r in rows["device"]] == [r[:4] for r in rows["host"]]
    np.testing.assert_allclose([float(r[4]) for r in rows["device"]],
                               [float(r[4]) for r in rows["host"]], atol=1e-5)
    csv = os.path.join(str(tmp_path / "device"), "val_results_single.csv")
    got = PortEvaluatorSO.from_files("scannet40", objects, classes, csv)
    want = EvaluatorSO.from_files("scannet40", objects, classes, csv)
    np.testing.assert_equal(got.eval_results(), want.eval_results())
    np.testing.assert_equal(got.eval_per_class(), want.eval_per_class())
    np.testing.assert_equal(got.eval_results(exclude_classes=("chair",)),
                            want.eval_results(exclude_classes=("chair",)))


def test_entry_points_default_to_the_card():
    args = eval_single_obj.get_args_parser().parse_args(
        ["--scan_folder", "s", "--val_list", "v"])
    # the reference's --device default "" means the card, as "cuda" does
    assert device_arg(args) == "cuda" and not args.host_rollout
    assert eval_single_obj.build_config(args).model.max_clicks == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            eval_single_obj.main(args)


def _write_rows(path, rows):
    with open(path, "w") as f:
        f.write("\n".join(" ".join(map(str, r)) for r in rows) + "\n")
    return str(path)


def _ap_rows():
    """Eight objects over 0-20 clicks: IoUs drawn per object, with exact
    ties at several click counts, two objects that never reach 0.5 and one
    that sits exactly on an overlap threshold."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(8):
        scene, obj = f"scene{i // 3:04d}_00", str(i % 3 + 1)
        for k in range(21):
            iou = float(np.round(min(1.0, rng.random() * 0.4 + k * 0.03), 2))
            if i in (2, 5):
                iou = min(iou, 0.45)
            if i == 7:
                iou = 0.5
            rows.append((i, scene.replace("scene", ""), obj, k, iou))
    return rows


def test_ap_matches_jax(tmp_path):
    csv = _write_rows(tmp_path / "ap.csv", _ap_rows())
    assert pap.num_gt_instances(csv) == jap.num_gt_instances(csv) == 8
    for k in (1, 5, 10, 20):
        np.testing.assert_array_equal(pap.ap_at_clicks(csv, k),
                                      jap.ap_at_clicks(csv, k))
    got, want = pap.evaluate_ap(csv), jap.evaluate_ap(csv)
    assert got == want and list(got) == list(range(1, 21))
    assert any(0.0 < v["all_ap"] < 1.0 for v in got.values())


def test_evaluator_so_matches_jax(tmp_path):
    """NoC, its clicks >= 20 fallback and IoU@k on rows that reach every
    threshold, rows that never reach 0.5 and an object outside the list;
    whole, without a class, and per class."""
    csv = _write_rows(tmp_path / "so.csv", _ap_rows())
    objects = np.array([[f"scene{i // 3:04d}_00", str(i % 3 + 1)]
                        for i in range(7)])
    classes = np.array(["chair", "table", "wall", "chair", "floor", "desk",
                        "not_in_vocabulary"])
    got = PortEvaluatorSO("scannet40", objects, classes, csv)
    want = EvaluatorSO("scannet40", objects, classes, csv)
    np.testing.assert_equal(got.eval_results(), want.eval_results())
    np.testing.assert_equal(
        got.eval_results(exclude_classes=("wall", "floor")),
        want.eval_results(exclude_classes=("wall", "floor")))
    np.testing.assert_equal(got.eval_per_class(), want.eval_per_class())
    assert set(got.eval_per_class()) == {"chair", "table", "wall", "floor",
                                         "desk"}
    assert np.isfinite(got.eval_results()["NoC@90"])


def test_compute_ap_prints_the_jax_table(tmp_path):
    csv = _write_rows(tmp_path / "ap.csv", _ap_rows())
    outs = []
    for mod in (port_compute_ap, jax_compute_ap):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            table = mod.main(types.SimpleNamespace(result_file=csv))
        outs.append((buf.getvalue(), table))
    assert outs[0] == outs[1]
    assert "Results for 20 clicks." in outs[0][0]
    assert port_compute_ap.get_args_parser().parse_args([]).result_file == \
        "results/val_results_single.csv"
