"""Operations of the model passes that a traced window noted (each
backbone pass with its pyramid's counts, each decoder pass with its rows
and click table), and the banded convs' least time: the work each launch
of the port's banded kernels is given, counted from the launch's arguments
(the level's rows and present k3 pairs, the conv's widths), whatever
computes it.

A pass with gradients counts three times its forward operations (forward
and backward; stated, not measured). The banded convs are those that the
port's routing sends to its kernels (agile3d_torch/models/backbone.py @
f6162fe: the k3 convs of 86 or more input channels at the two finest
levels of 32,768 or more padded rows; the k5 stem in eval): with
gradients each also has a dX (the same work, widths swapped) and a dW
launch.
"""

from __future__ import annotations

from benchmark.counts.costs import (
    PEAK_BF16_FLOPS,
    PEAK_HBM_BPS,
    LevelCounts,
    backbone_flops,
    decoder_flops,
)

BANDED_MIN_CIN = 86
BANDED_MIN_ROWS = 32768
BANDED_LEVELS = 2


def _levels(levels) -> list[LevelCounts]:
    return [LevelCounts(n, k3, k5, down, up)
            for n, _, k3, k5, down, up in levels]


def model_flops(passes, cfg: dict, upto: int | None = None) -> float:
    """Forward operations of the noted passes (the first ``upto`` notes),
    three times for those with gradients."""
    total = 0.0
    dec = cfg["decoder"]
    for rec in passes[:upto]:
        if rec[0] == "backbone":
            f = backbone_flops(_levels(rec[2]), cfg["backbone"])
            total += f * (3 if rec[1] else 1)
        elif rec[0] == "decoder":
            _, grad, n_valid, b, width = rec
            f = decoder_flops(n_valid / b, dec["num_bg_queries"] + width,
                              dec) * b
            total += f * (3 if grad else 1)
    return total


def banded_convs(bb: dict):
    """(level, cin, cout) of each k3 conv the routing may band."""
    planes, layers, d0 = bb["planes"], bb["layers"], bb["init_dim"]
    out = []
    down_in = d0
    for i in range(4):
        for b in range(layers[i]):
            cin = down_in if b == 0 else planes[i]
            out += [(i + 1, cin, planes[i]), (i + 1, planes[i], planes[i])]
        down_in = planes[i]
    skips = [planes[2], planes[1], planes[0], d0]
    for j in range(4):
        i, tgt = 4 + j, 3 - j
        for b in range(layers[i]):
            cin = planes[i] + skips[j] if b == 0 else planes[i]
            out += [(tgt, cin, planes[i]), (tgt, planes[i], planes[i])]
    return [(lv, cin, cout) for lv, cin, cout in out
            if lv < BANDED_LEVELS and cin >= BANDED_MIN_CIN]


def banded_least_s(passes, bb: dict) -> float:
    """The least time of the banded launches of every noted backbone pass:
    per launch the larger of its operations at the bf16 peak and its
    compulsory bytes (f32 inputs read once, output written once, the
    weights) at the HBM rate."""
    total = 0.0

    def least(flops, nbytes):
        return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BPS)

    for rec in passes:
        if rec[0] != "backbone":
            continue
        grad, levels = rec[1], rec[2]
        for lv, cin, cout in banded_convs(bb):
            n, padded, pairs = levels[lv][0], levels[lv][1], levels[lv][2]
            if padded < BANDED_MIN_ROWS:
                continue
            w = 27 * cin * cout * 4
            flops = 2 * pairs * cin * cout
            total += least(flops, (n * cin + n * cout) * 4 + w)
            if grad:
                total += least(flops, (n * cout + n * cin) * 4 + w)   # dX
                total += least(flops, (n * cin + n * cout) * 4 + w)   # dW
    return total
