"""The model's operations in the steps completed in the window (each
backbone and decoder pass of the rollout and of the supervised step, from
the pass's own shapes, ``counts/passes.py``; a pass with gradients counts
three times its forward), over the window up to the last completed step,
as a share in % of the card's bf16 peak (989 TFLOP/s; the program runs
float32)."""

from benchmark.counts.costs import PEAK_BF16_FLOPS
from benchmark.counts.passes import model_flops


def read(run):
    w = run.layer
    if not w.get("steps") or not w.get("passes"):
        return None
    flops = model_flops(w["passes"], run.cell.config, w["cut"])
    return 100.0 * flops / w["window_s"] / PEAK_BF16_FLOPS
