"""The boundary-distance kernel's least work.

Frozen copy of agile3d_torch/ops/boundary_dist.py::distance_work @ f6162fe:
(operations, bytes) that one call needs at the least: one pair a query
row, 8 FP32 operations (3 differences, 3 products, 2 sums); coordinates,
cluster ids, valid flags and the query mask read once, the distances
written once. On the card's peaks (67 TFLOP/s of FP32 outside the tensor
cores, 3.35 TB/s) the bytes bound it at every size the benchmark runs: a
call's least time is its rows' bytes at the HBM rate, whatever the error
rows are.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12


def distance_work(b: int, n: int, query_rows: int | None):
    rows = b * n if query_rows is None else query_rows
    nbytes = b * n * (12 + 4 + 1 + 4 + (0 if query_rows is None else 1))
    return 8.0 * rows, float(nbytes)


def least_s(b: int, n: int, query_rows: int) -> float:
    flops, nbytes = distance_work(b, n, query_rows)
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BPS)
