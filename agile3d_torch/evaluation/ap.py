"""Class-agnostic AP / AP50 / AP25 from single-object result CSVs (the
port's own copy of the JAX package's ``evaluation/ap.py``): at each click
count, every object's IoU is one prediction; the precision-recall curve of
the predictions above each overlap threshold is integrated ScanNet-style."""

from __future__ import annotations

import numpy as np

AP_OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


def _read_ious_at(result_file: str, clicks_num: int) -> np.ndarray:
    ious = []
    with open(result_file) as f:
        for line in f:
            s = line.rstrip().split(" ")
            if len(s) >= 5 and float(s[3]) == clicks_num:
                ious.append(float(s[4]))
    return np.asarray(ious)


def num_gt_instances(result_file: str) -> int:
    pairs = set()
    with open(result_file) as f:
        for line in f:
            s = line.rstrip().split(" ")
            if len(s) >= 5:
                pairs.add((s[1], s[2]))
    return len(pairs)


def ap_at_clicks(result_file: str, clicks_num: int,
                 n_gt: int | None = None) -> np.ndarray:
    """AP per overlap threshold (``AP_OVERLAPS``) for the predictions at
    exactly ``clicks_num`` clicks."""
    if n_gt is None:
        n_gt = num_gt_instances(result_file)
    ious = _read_ious_at(result_file, clicks_num)

    ap = np.zeros(len(AP_OVERLAPS))
    for oi, th in enumerate(AP_OVERLAPS):
        matched = ious > th
        hard_fn = int((~matched).sum())
        y_score = np.sort(ious[matched])
        y_cum = np.arange(1, len(y_score) + 1, dtype=float)

        thresholds, uniq_idx = np.unique(y_score, return_index=True)
        n = len(y_score)
        n_true = float(n)

        precision = np.zeros(len(uniq_idx) + 1)
        recall = np.zeros(len(uniq_idx) + 1)
        y_cum_ext = np.append(y_cum, 0.0)
        for r, i in enumerate(uniq_idx):
            cum = y_cum_ext[i - 1]
            tp = n_true - cum
            fp = n - i - tp
            fn = cum + hard_fn
            precision[r] = tp / (tp + fp) if (tp + fp) else 0.0
            recall[r] = tp / (tp + fn) if (tp + fn) else 0.0
        precision[-1] = 1.0
        recall[-1] = 0.0

        r_conv = np.concatenate([[recall[0]], recall, [0.0]])
        step = np.convolve(r_conv, [-0.5, 0, 0.5], "valid")
        ap[oi] = float(np.dot(precision, step))
    return ap


def compute_averages(aps: np.ndarray) -> dict:
    """AP over the 0.50-0.90 thresholds, AP50 and AP25."""
    o50 = np.isclose(AP_OVERLAPS, 0.50)
    o25 = np.isclose(AP_OVERLAPS, 0.25)
    return {
        "all_ap": float(np.nanmean(aps[~o25])),
        "all_ap_50%": float(np.nanmean(aps[o50])),
        "all_ap_25%": float(np.nanmean(aps[o25])),
    }


def evaluate_ap(result_file: str, clicks_range=range(1, 21)) -> dict:
    """{clicks: compute_averages(...)} over the click counts."""
    n_gt = num_gt_instances(result_file)
    out = {}
    for k in clicks_range:
        out[k] = compute_averages(ap_at_clicks(result_file, k, n_gt))
    return out
