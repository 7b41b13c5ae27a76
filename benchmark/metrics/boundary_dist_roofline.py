"""The boundary-distance kernel's share of its roofline, in %: the least
time of each call in the traced window (``counts/distance.py``, the
copied ``distance_work``: one call a device round, over the scene's
padded rows, with a query mask; bytes bound it) over the device time of
the kernel's four passes by name (csrc/boundary_dist.cu). Nothing to read
where the kernel did not run."""

from benchmark.counts.distance import least_s
from benchmark.harness.trace import base_name

KERNELS = ("count_kernel", "compact_kernel", "box_kernel", "dist_kernel")


def read(run):
    t = run.trace
    device_s = sum(s for n, s in t.kernel_s.items()
                   if base_name(n) in KERNELS)
    calls = sum(c for n, c in t.kernel_n.items() if base_name(n)
                == "dist_kernel")
    rows = run.layer.get("rows")
    if not device_s or not calls or not rows:
        return None
    # the query rows do not change the least time (bytes bound it): take
    # them all
    return 100.0 * calls * least_s(1, rows, rows) / device_s
