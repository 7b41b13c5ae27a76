"""Offline NoC / IoU@k evaluator over per-click result CSVs (the port's own
copy of ``EvaluatorMO`` from the JAX package's ``evaluation/evaluators.py``).

Rows are ``id scene obj clicks iou`` (space separated; ``clicks`` is clicks
per object).

  * NoC@tau: per object, the first (file-order) click count whose IoU
    reaches tau; objects that never reach tau fall back to their first row
    with clicks >= 20. Mean over objects.
  * IoU@k: mean IoU over rows at exactly k clicks, keyed by the raw CSV
    string ('1.0', '3.0', ...).
"""

from __future__ import annotations

import json
from collections import defaultdict


def _parse_rows(result_file: str):
    rows = []
    with open(result_file) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            s = line.split(" ")
            rows.append((s[1].replace("scene", ""), s[2], s[3], float(s[4])))
    return rows


class _CurveAccumulator:
    """NoC + per-click IoU statistics over an object subset."""

    def __init__(self, iou_threshold: float, noc_cap: float = 20.0):
        self.tau = iou_threshold
        self.cap = noc_cap
        self.noc = {}
        self.iou_per_click = defaultdict(float)
        self.count_per_click = defaultdict(int)

    def add(self, key: str, clicks_str: str, iou: float):
        clicks = float(clicks_str)
        if key not in self.noc:
            if iou >= self.tau:
                self.noc[key] = clicks
            elif clicks >= self.cap and iou >= 0:
                self.noc[key] = clicks
        self.iou_per_click[clicks_str] += iou
        self.count_per_click[clicks_str] += 1


def _results_dict(accs: dict, click_keys: list[str], thresholds):
    out = {}
    for tau in thresholds:
        acc = accs[tau]
        out[f"NoC@{int(tau * 100)}"] = (
            sum(acc.noc.values()) / len(acc.noc) if acc.noc else float("nan"))
    acc0 = accs[thresholds[0]]
    for ck in click_keys:
        if acc0.count_per_click.get(ck):
            out[f"IoU@{int(float(ck))}"] = (acc0.iou_per_click[ck]
                                            / acc0.count_per_click[ck])
    return out


class EvaluatorMO:
    """Multi-object evaluator. The object key is scene_name + '_' +
    num_obj, restricted to the validation list."""

    def __init__(self, scene_list_file, result_file,
                 iou_thresholds=(0.5, 0.65, 0.8, 0.85, 0.9)):
        if isinstance(scene_list_file, (dict, list)):
            dataset_list = scene_list_file
        else:
            with open(scene_list_file) as f:
                dataset_list = json.load(f)
        self.keep = {
            k.replace("scene", "").replace("obj_", "") for k in dataset_list
        }
        self.result_file = result_file
        self.thresholds = list(iou_thresholds)

    def eval_results(self) -> dict:
        accs = {t: _CurveAccumulator(t) for t in self.thresholds}
        for scene, obj, clicks_str, iou in _parse_rows(self.result_file):
            key = scene + "_" + obj
            if key not in self.keep:
                continue
            for acc in accs.values():
                acc.add(key, clicks_str, iou)
        return _results_dict(accs, ["1.0", "3.0", "5.0", "10.0", "15.0"],
                             self.thresholds)
