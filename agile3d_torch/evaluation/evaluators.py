"""Offline NoC / IoU@k evaluators over per-click result CSVs (the port's
own copy of the JAX package's ``evaluation/evaluators.py``).

Rows are ``id scene obj clicks iou`` (space separated; ``clicks`` is clicks
per object for multi-object, absolute clicks for single-object).

  * NoC@tau: per object, the first (file-order) click count whose IoU
    reaches tau; objects that never reach tau fall back to their first row
    with clicks >= 20. Mean over objects.
  * IoU@k: mean IoU over rows at exactly k clicks, keyed by the raw CSV
    string ('1.0', '3.0', ... multi-object; '1', '2', ... single-object).
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from agile3d_torch.evaluation.labels import DATASET_CLASSES


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


class EvaluatorSO:
    """Single-object evaluator: the objects of the (scene, object id) list,
    optionally without some semantic classes; ``eval_per_class`` gives the
    same metrics per class of the dataset's vocabulary."""

    def __init__(self, dataset, object_list, object_classes, result_file,
                 iou_thresholds=(0.5, 0.65, 0.8, 0.85, 0.9)):
        self.classes_vocab = DATASET_CLASSES[dataset]
        self.objects = np.asarray(object_list)          # [M, 2] scene, obj
        self.object_classes = np.asarray(object_classes)  # [M] class names
        self.result_file = result_file
        self.thresholds = list(iou_thresholds)

    @classmethod
    def from_files(cls, dataset, object_list_file, object_classes_file,
                   result_file, iou_thresholds=(0.5, 0.65, 0.8, 0.85, 0.9)):
        return cls(dataset, np.load(object_list_file),
                   np.loadtxt(object_classes_file, dtype=str), result_file,
                   iou_thresholds)

    def _accumulate(self, objects) -> dict:
        keep = {row[0].replace("scene", "") + "_" + row[1] for row in objects}
        accs = {t: _CurveAccumulator(t) for t in self.thresholds}
        for scene, obj, clicks_str, iou in _parse_rows(self.result_file):
            key = scene + "_" + obj
            if key in keep:
                for acc in accs.values():
                    acc.add(key, clicks_str, iou)
        return accs

    def eval_results(self, exclude_classes=()) -> dict:
        mask = np.isin(self.object_classes, list(exclude_classes), invert=True)
        return _results_dict(self._accumulate(self.objects[mask]),
                             ["1", "2", "3", "5", "10", "15"], self.thresholds)

    def eval_per_class(self) -> dict:
        """{class: the eval_results dict over that class's objects}, for the
        classes of the vocabulary that have an object in the results."""
        out = {}
        for cls_name in sorted(set(self.object_classes) & self.classes_vocab):
            accs = self._accumulate(
                self.objects[self.object_classes == cls_name])
            if accs[self.thresholds[0]].noc:
                out[cls_name] = _results_dict(
                    accs, ["1", "2", "3", "5", "10", "15"], self.thresholds)
        return out
