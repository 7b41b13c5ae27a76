"""The banded convs' share of their roofline, in %: the least time of the
work each launch of the port's banded kernels (csrc/banded_conv.cu:
forward, dX, dW and their casts) was given in the traced window, counted
from the launch's arguments (``counts/passes.py``), over those kernels'
device time by name. Nothing to read where no banded kernel ran."""

from benchmark.counts.passes import banded_least_s
from benchmark.harness.trace import base_name

KERNELS = ("window_conv_kernel", "banded_conv_dw_kernel",
           "sum_partials_kernel", "cast_rows_kernel",
           "cast_weight_image_kernel", "cast_row_image_kernel")


def read(run):
    device_s = sum(s for n, s in run.trace.kernel_s.items()
                   if base_name(n) in KERNELS)
    passes = run.layer.get("passes")
    if not device_s or not passes:
        return None
    return 100.0 * banded_least_s(passes, run.cell.config["backbone"]) \
        / device_s
