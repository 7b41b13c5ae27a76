"""BENCHMARK.json against the contract the driver holds it to, and every
cell resolved by name to its files."""

import json
import os
import re

import pytest

from benchmark.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    cells = len(manifest["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    assert len(set(n for _, n in names)) == len(names)
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for w in manifest["workloads"]:
        mine = [m for m in e2e.values()
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        lay = [m for m in manifest["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert lay
        for m in lay:
            assert m["moves"] in [x["name"] for x in mine]


def test_every_cell_resolves_by_name(manifest):
    from benchmark.harness import cells

    for w in manifest["workloads"]:
        cell = cells.resolve(ROOT, w["name"], manifest)
        assert hasattr(cell.kind, "setup")
        assert cell.config["backbone"]["planes"]
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
        for r in cell.readers.values():
            assert callable(r.read)
        assert cell.limits, f"{w['name']} has no limits"


def test_a_new_cell_is_data(manifest, tmp_path):
    """A cell added as entries and files only: the resolver finds it."""
    from benchmark.harness import cells

    m = json.loads(json.dumps(manifest))
    first = m["workloads"][0]
    m["workloads"].append(dict(first, name="added-cell"))
    cell = cells.resolve(ROOT, "added-cell", m)
    assert cell.traffic_name == first["traffic"]
    assert cell.kind.__name__.endswith(cell.traffic["kind"])


def test_configs(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert isinstance(cfg["assumed"], list) and cfg["assumed"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
