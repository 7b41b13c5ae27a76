"""The model's operations in the traced window (each scene's backbone from
its pyramid, each round's decoder pass from its rows and click table,
``counts/passes.py``) over the window up to the last scene's end, as a
share in % of the card's bf16 peak (989 TFLOP/s; the program runs
float32). A traced window ends with the scene in flight at its end, so
no pass is cut."""

from benchmark.counts.costs import PEAK_BF16_FLOPS
from benchmark.counts.passes import model_flops


def read(run):
    w = run.layer
    if not w.get("scenes") or not w.get("passes"):
        return None
    return 100.0 * model_flops(w["passes"], run.cell.config) \
        / w["window_s"] / PEAK_BF16_FLOPS
