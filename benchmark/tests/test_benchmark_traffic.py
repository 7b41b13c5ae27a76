"""The scene and click generators: the same seed gives the same inputs,
another seed the same sizes."""

import numpy as np

from benchmark.gen import scenes as gen
from benchmark.harness.seeds import np_rng, torch_seed

SPEC = {"points": 3000, "extent": 3.0, "objects": 4, "noise": 0.03}


def test_scenes_follow_the_seed():
    big = 2 ** 31 + 12345
    a = gen.scene_from(SPEC, np_rng(big, "scenes"))
    b = gen.scene_from(SPEC, np_rng(big, "scenes"))
    c = gen.scene_from(SPEC, np_rng(big + 1, "scenes"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    for x, y in zip(a, c):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert sorted(np.unique(a[2])) == list(range(SPEC["objects"] + 1))


def test_streams_are_apart():
    s = 2 ** 31 + 7
    assert np_rng(s, "a").integers(2 ** 62) != np_rng(s, "b").integers(2 ** 62)
    assert torch_seed(s) == torch_seed(s)
    assert 0 <= torch_seed(-5) < 2 ** 62


def test_files_round_trip(tmp_path):
    from agile3d_torch.data.ply import read_ply

    scene = gen.scene_from(SPEC, np_rng(3, "scenes"))
    scans, listing = gen.write_scan_list(str(tmp_path), [scene], 4)
    pc = read_ply(f"{scans}/scene0000_00.ply")
    np.testing.assert_array_equal(pc["x"], scene[0][:, 0])
    np.testing.assert_array_equal(pc["label"], scene[2])
    folder = gen.write_tool_scenes(str(tmp_path / "tool"), [scene])
    assert read_ply(f"{folder}/scene_0000/label.ply")["label"].shape == (3000,)


def test_serve_clicks_follow_the_seed():
    """The serve mix's click plan: round-robin objects, points of the
    object, the same for the same seed."""
    from benchmark.kinds.serve import ServeSession

    s = ServeSession.__new__(ServeSession)
    scene = gen.scene_from(SPEC, np_rng(9, "scenes"))
    s.n_obj = 4
    s.obj_points = [[np.nonzero(scene[2] == o)[0] for o in range(1, 5)]]
    a = s._clicks(0, 10, np_rng(9, "clicks"))
    b = s._clicks(0, 10, np_rng(9, "clicks"))
    assert a == b
    assert [o for o, _ in a] == [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
    assert all(scene[2][p] == o for o, p in a)
