"""A cell of ``BENCHMARK.json`` resolved by name to its files: nothing here
names a cell, a configuration, a traffic mix or a metric."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: dict          # benchmark/configs/<config>.json
    traffic_name: str
    traffic: dict         # benchmark/traffic/<traffic>.json
    kind: object          # benchmark/kinds/<traffic["kind"]>.py
    end_to_end: list      # the manifest's end-to-end metrics of this cell
    per_layer: list       # the manifest's per-layer metrics of this cell
    readers: dict         # per-layer metric name -> reader module
    limits: dict          # benchmark/limits/<cell>.json
    root: str


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(bench: str, metric: str) -> str:
    """``metrics/<metric>.py``, else the reader its split names share:
    ``metrics/idle_share.py`` reads ``idle_share.serve`` and
    ``idle_share.train`` alike."""
    own = os.path.join(bench, "metrics", metric + ".py")
    if os.path.exists(own):
        return own
    return os.path.join(bench, "metrics", metric.split(".")[0] + ".py")


def resolve(root: str, workload: str, manifest: dict | None = None) -> Cell:
    """The cell named ``workload``, with every file it needs read."""
    if manifest is None:
        manifest = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"error: no cell {workload!r} in BENCHMARK.json "
                         f"(cells: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    bench = os.path.join(root, "benchmark")
    traffic = _json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    kind = load_module(os.path.join(bench, "kinds", traffic["kind"] + ".py"),
                       f"benchmark.kinds.{traffic['kind']}")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    layer = [m for m in manifest["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: load_module(
        _reader(bench, m["name"]),
        "benchmark.metrics." + m["name"].replace(".", "_"))
        for m in layer}
    limits_path = os.path.join(bench, "limits", workload + ".json")
    limits = _json(limits_path)["limits"] if os.path.exists(limits_path) \
        else {}
    return Cell(workload, int(w["chips"]), w["config"],
                _json(os.path.join(root, entry["file"])), w["traffic"],
                traffic, kind, e2e, layer, readers, limits, root)
