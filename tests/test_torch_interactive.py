"""The port's annotation tool against the JAX package's: scene discovery
and the PLY scenes (point clouds and a mesh), ``get_next_click`` of the two
servers on the same scene, weights and clicks (f32: >= 0.999 of points
agree and the IoU at atol 1e-4; bf16: >= 0.99 agree), ``nearest_voxel``,
the session files, the picking mirror on the JAX package's pinned
geometry, one HTTP session on localhost and the terminal REPL."""

import dataclasses
import json
import os
import re
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from agile3d_torch import run_ui
from agile3d_torch.cli import device_arg
from agile3d_torch.config import Config as PortConfig
from agile3d_torch.interactive import InteractiveDataLoader
from agile3d_torch.interactive import InteractiveSegmentationServer
from agile3d_torch.interactive import picking as ppick
from agile3d_torch.interactive.server import clicks_dict_to_arrays
from agile3d_torch.interactive.web import make_handler
from agile3d_tpu import interactive as jinter
from agile3d_tpu.config import Config
from agile3d_tpu.data.ply import write_ply
from agile3d_tpu.interactive import picking as jpick
from agile3d_tpu.interactive.server import (
    clicks_dict_to_arrays as jclicks_dict_to_arrays,
)
from tests.synthetic import make_scene
from tests.test_picking import H, W, _mvp, _pixel_of, _scene
from tests.test_torch_model import SMALL, randomized_weights
from tests.test_torch_weights import port_model_config

torch.set_num_threads(1)

BUCKETS = (1024, 2048, 4096)
N_FACES = 500


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("interactive"))
    rng = np.random.default_rng(0)
    for name in ("scene_alpha", "scene_beta", "scene_mesh"):
        d = os.path.join(root, name)
        os.makedirs(d)
        coords, colors, labels = make_scene(rng, n_points=1500, num_obj=2)
        fields = {"x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
                  "R": colors[:, 0], "G": colors[:, 1], "B": colors[:, 2]}
        faces = (np.arange(3 * N_FACES).reshape(-1, 3)
                 if name == "scene_mesh" else None)
        write_ply(os.path.join(d, "scan.ply"), fields, faces=faces)
        if name != "scene_beta":
            write_ply(os.path.join(d, "label.ply"),
                      {**fields, "label": labels})
    os.makedirs(os.path.join(root, "not_a_scene"))
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    sd, _, _, _ = randomized_weights(SMALL, 5, np.random.default_rng(5))
    path = str(tmp_path_factory.mktemp("weights") / "small.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    return path


def _servers(scene_dir, weights, dtype):
    """The JAX server and the port's on the same scene folder and weights
    (each with its own user folder)."""
    jcfg = Config(model=dataclasses.replace(SMALL, decoder_dtype=dtype),
                  buckets=BUCKETS)
    pcfg = PortConfig(model=port_model_config(jcfg.model), buckets=BUCKETS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AGILE3D_WARM", "0")
        jserver = jinter.InteractiveSegmentationServer(
            jinter.InteractiveDataLoader(scene_dir, f"jax_{dtype}"),
            weights=weights, cfg=jcfg)
    pserver = InteractiveSegmentationServer(
        InteractiveDataLoader(scene_dir, f"port_{dtype}"), weights=weights,
        cfg=pcfg, device="cpu")
    return jserver, pserver


@pytest.fixture(scope="module")
def f32_servers(scene_dir, weights):
    return _servers(scene_dir, weights, "float32")


def _click_sets(labels):
    """Three growing click sets: one click on each object, then a
    background click, then a second click on object 1."""
    first = {o: int(np.nonzero(labels == o)[0][0]) for o in (0, 1, 2)}
    second = int(np.nonzero(labels == 1)[0][-1])
    return [
        ({"0": [], "1": [first[1]], "2": [first[2]]},
         {"0": [], "1": [0], "2": [1]}),
        ({"0": [first[0]], "1": [first[1]], "2": [first[2]]},
         {"0": [2], "1": [0], "2": [1]}),
        ({"0": [first[0]], "1": [first[1], second], "2": [first[2]]},
         {"0": [2], "1": [0, 3], "2": [1]}),
    ]


def test_scene_discovery_matches_jax(scene_dir):
    p = InteractiveDataLoader(scene_dir, "discovery")
    j = jinter.InteractiveDataLoader(scene_dir, "discovery_jax")
    assert p.scene_names == j.scene_names == ["alpha", "beta", "mesh"]
    for i in range(len(p)):
        assert p.load_scene(i) == j.load_scene(i)
        np.testing.assert_array_equal(p.coords, j.coords)
        np.testing.assert_array_equal(p.colors, j.colors)
        assert (p.labels_full is None) == (j.labels_full is None)
        if p.labels_full is not None:
            np.testing.assert_array_equal(p.labels_full, j.labels_full)
        assert p.point_type == j.point_type
        if j.faces is None:
            assert p.faces is None
        else:
            np.testing.assert_array_equal(p.faces, j.faces)
    assert p.point_type == "mesh" and p.faces.shape == (N_FACES, 3)
    # object masks persist per user across loaders
    p.add_object("chair")
    p.update_object("chair", np.ones(len(p.coords), np.int8))
    again = InteractiveDataLoader(scene_dir, "discovery")
    again.load_scene(2)
    assert again.object_names == ["chair"]
    assert again.occupied_points_except("table").all()
    with pytest.raises(ValueError):
        InteractiveDataLoader(os.path.join(scene_dir, "not_a_scene"))


def test_clicks_dict_to_arrays_matches_jax():
    click_idx = {"0": [5], "1": [7, 9], "3": [11]}
    times = {"0": [2], "1": [0, 3], "3": [1]}
    for got, want in zip(clicks_dict_to_arrays(click_idx, times, 8),
                         jclicks_dict_to_arrays(click_idx, times, 8)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        clicks_dict_to_arrays(click_idx, times, 3)


def test_get_next_click_matches_jax_f32(f32_servers):
    jserver, pserver = f32_servers
    assert pserver.n_valid == jserver.n_valid
    np.testing.assert_array_equal(pserver.sample.raw_coords,
                                  jserver.sample.raw_coords)
    for click_idx, times in _click_sets(pserver.sample.labels):
        jv, jfull, jiou = jserver.get_next_click(click_idx, times,
                                                 return_voxel=True)
        pv, pfull, piou = pserver.get_next_click(click_idx, times,
                                                 return_voxel=True)
        assert pv.dtype == pfull.dtype == np.uint8
        assert pfull.shape == jfull.shape == pserver.loader.labels_full.shape
        assert (pfull == jfull).mean() >= 0.999
        assert (pv == jv).mean() >= 0.999
        np.testing.assert_allclose(piou, jiou, rtol=0, atol=1e-4)
        for obj, rows in click_idx.items():
            assert (pv[rows] == int(obj)).all()  # the click override


def test_nearest_voxel_matches_jax(f32_servers):
    jserver, pserver = f32_servers
    coords = pserver.loader.coords
    for i in (0, 5, 700, len(coords) - 1):
        xyz = coords[i] + np.float32(0.01)
        assert pserver.nearest_voxel(xyz) == jserver.nearest_voxel(xyz)


def test_session_files_match_jax(f32_servers):
    jserver, pserver = f32_servers
    click_idx, times = _click_sets(pserver.sample.labels)[0]
    for s in (jserver, pserver):
        for folder in (s.loader.mask_folder, s.loader.click_folder):
            for f in os.listdir(folder):
                os.remove(os.path.join(folder, f))
        if os.path.exists(s.loader.record_path):
            os.remove(s.loader.record_path)
        s.get_next_click(click_idx, times)
    strip = lambda line: line.split("  ", 1)[1]  # drop the time stamp
    lines = [open(s.loader.record_path).read().splitlines()
             for s in (jserver, pserver)]
    assert [strip(x) for x in lines[1]] == [strip(x) for x in lines[0]]
    assert re.match(r"\S+  alpha  NumObjects:2  AvgNumClicks:1.0  mIoU:",
                    lines[1][0])
    for attr in ("mask_folder", "click_folder"):
        names = [sorted(os.listdir(getattr(s.loader, attr)))
                 for s in (jserver, pserver)]
        assert names[1] == names[0] and len(names[1]) == 1
    mask = np.load(os.path.join(pserver.loader.mask_folder,
                                os.listdir(pserver.loader.mask_folder)[0]))
    np.testing.assert_array_equal(mask, pserver.get_next_click(
        click_idx, times, record=False)[0])
    saved = np.load(os.path.join(pserver.loader.click_folder,
                                 os.listdir(pserver.loader.click_folder)[0]),
                    allow_pickle=True).item()
    assert saved == {"click_idx": click_idx, "click_time": times}


def test_get_next_click_matches_jax_bf16(scene_dir, weights):
    """The serving default: bf16 decoder in both servers; the port's scene
    features are bf16 (its coordinates f32) and its masks agree with
    JAX's on >= 0.99 of points."""
    jserver, pserver = _servers(scene_dir, weights, "bfloat16")
    scene = pserver.scene
    assert scene.mask_feat.dtype == scene.pos_pcd.dtype == torch.bfloat16
    assert scene.raw.dtype == scene.cmin.dtype == torch.float32
    for click_idx, times in _click_sets(pserver.sample.labels):
        jfull, jiou = jserver.get_next_click(click_idx, times, record=False)
        pfull, piou = pserver.get_next_click(click_idx, times, record=False)
        assert (pfull == jfull).mean() >= 0.99
        assert 0.0 <= piou <= 1.0


def test_picking_matches_jax():
    """The picking mirror on the JAX package's pinned geometry (a front
    plane occluding a rear one): every pixel of a coarse grid, the
    projection and both pick semantics; and the viewer's pick() that it
    mirrors is the JAX viewer's."""
    pos, _ = _scene()
    mvp = _mvp()
    for a, b in zip(ppick.project(pos, mvp, W, H), jpick.project(pos, mvp, W, H)):
        np.testing.assert_array_equal(a, b)
    for mx in range(0, W, 40):
        for my in range(0, H, 40):
            assert ppick.pick_projected_nearest(pos, mvp, mx, my, W, H) == \
                jpick.pick_projected_nearest(pos, mvp, mx, my, W, H)
            assert ppick.pick_depth_unproject(pos, mvp, mx, my, W, H) == \
                jpick.pick_depth_unproject(pos, mvp, mx, my, W, H)
    for i in (0, 40, len(pos) - 1):
        mx, my = _pixel_of(pos, mvp, i)
        assert ppick.pick_projected_nearest(pos, mvp, mx, my, W, H) == \
            jpick.pick_projected_nearest(pos, mvp, mx, my, W, H)
    assert (ppick.PICK_RADIUS_PX, ppick.NEAR_W) == (jpick.PICK_RADIUS_PX,
                                                    jpick.NEAR_W)

    def pick_js(path):
        src = open(path).read()
        start = src.index("function pick(")
        return src[start:src.index("\n}", start)]

    here = os.path.dirname(os.path.abspath(ppick.__file__))
    there = os.path.dirname(os.path.abspath(jpick.__file__))
    assert pick_js(os.path.join(here, "viewer.html")) == \
        pick_js(os.path.join(there, "viewer.html"))


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read(), dict(r.headers)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read(), dict(r.headers)


def test_http_session(f32_servers):
    """GET /, /scene, /points; POST /click (the labels of get_next_click,
    its IoU in X-IoU); /scene/next to a scene without labels and on to a
    mesh, whose /mesh streams the surface; /scene/prev back."""
    _, seg = f32_servers
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(seg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body, _ = _get(base + "/")
        assert b"AGILE3D" in body and b"webgl" in body.lower()
        meta = json.loads(_get(base + "/scene")[0])
        assert meta["name"] == "alpha" and meta["n_vox"] == seg.n_valid
        assert meta["has_labels"] is True and meta["mesh"] is False
        body, headers = _get(base + "/points")
        n = int(headers["X-Count"])
        assert n == seg.n_valid and len(body) == n * 15
        np.testing.assert_array_equal(
            np.frombuffer(body[:n * 12], np.float32).reshape(n, 3),
            seg.sample.raw_coords)

        click_idx, times = _click_sets(seg.sample.labels)[1]
        body, headers = _post(base + "/click", {"click_idx": click_idx,
                                                "click_time_idx": times})
        labels = np.frombuffer(body, np.uint8)
        want_v, _, want_iou = seg.get_next_click(click_idx, times,
                                                 record=False,
                                                 return_voxel=True)
        np.testing.assert_array_equal(labels, want_v)
        assert headers["X-IoU"] == f"{want_iou:.4f}"
        assert float(headers["X-Latency-Ms"]) > 0

        assert json.loads(_post(base + "/scene/next", {})[0]) == \
            {"name": "beta"}
        meta = json.loads(_get(base + "/scene")[0])
        assert meta["has_labels"] is False
        _, headers = _post(base + "/click", {"click_idx": {"1": [3]},
                                             "click_time_idx": {"1": [0]}})
        assert headers["X-IoU"] == "NA"
        assert json.loads(_post(base + "/scene/next", {})[0]) == \
            {"name": "mesh"}
        meta = json.loads(_get(base + "/scene")[0])
        assert meta["mesh"] is True and meta["n_faces"] == N_FACES
        nf = meta["n_full"]
        body, headers = _get(base + "/mesh")
        assert int(headers["X-Faces"]) == N_FACES
        assert len(body) == nf * 19 + N_FACES * 12
        np.testing.assert_array_equal(
            np.frombuffer(body[nf * 15:nf * 19], np.uint32),
            seg.sample.inverse_map)
        assert json.loads(_post(base + "/scene/next", {})[0]) == \
            {"name": None}
        for name in ("beta", "alpha"):
            assert json.loads(_post(base + "/scene/prev", {})[0]) == \
                {"name": name}
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nothing")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive() and seg.loader.index == 0


def test_terminal_repl(f32_servers):
    _, seg = f32_servers
    lines = iter(["1 0.5 0.5 0.1", "2 1 1", "0 0.2 0.3 0.0", "next",
                  "prev", "quit", "1 0 0 0"])
    out = []
    run_ui.terminal_loop(seg, read=lambda prompt: next(lines),
                         write=out.append)
    assert out[0].startswith("scene: alpha")
    assert re.fullmatch(r"clicks: 1, mIoU: \d+(\.\d)?", out[1])
    assert out[2] == "expected: <obj_id> <x> <y> <z>"
    assert out[3].startswith("clicks: 2, mIoU: ")
    assert out[4:] == ["scene: beta", "scene: alpha"]
    assert seg.loader.index == 0


def test_run_ui_defaults(scene_dir):
    args = run_ui.get_args_parser().parse_args(
        ["--dataset_scenes", scene_dir])
    # the reference's --device default "" means the card, as "cuda" does
    assert device_arg(args) == "cuda" and args.decoder_dtype == "bfloat16"
    assert not args.terminal and args.port == 8008
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            run_ui.main(args)
