"""The decoder's useful operations over the window's clicks (each pass
over the scene's voxels with the clicks it carries, ``counts/costs.py``),
over the clicks' wall time, as a share in % of the card's bf16 peak."""

from benchmark.counts.costs import PEAK_BF16_FLOPS


def read(run):
    w = run.layer
    if not w.get("clicks") or not w.get("click_wall_s"):
        return None
    return 100.0 * w["decoder_flops"] / w["click_wall_s"] / PEAK_BF16_FLOPS
