"""Operation and byte counts of the model, and the card's peaks.

Frozen copy of agile3d_torch/utils/costs.py @ f6162fe (``OpCost``,
``_conv_cost``, ``_bn_relu_cost``, ``backbone_costs``, ``decoder_costs``,
the peaks), with two changes: the configuration is the benchmark's
configuration dict, and a map may be a numpy array or a torch tensor (its
present entries are counted where it lives). The counts are JAX's integer
for integer:

  flops          2 * pairs * cin * cout per sparse conv, 2 * M * N * K
                 per matmul
  stream_bytes   every input read once and every output written once
                 (and the weights): the bandwidth roofline's bytes
  gather_rows    rows gathered by neighbour index (the sparse convs' pairs)

Peaks: one NVIDIA H100 SXM's data-sheet figures, 989e12 dense bf16
tensor-core FLOP/s and 3.35e12 B/s of HBM3. Every ``mfu`` of the benchmark
is a share of the bf16 peak, also for work the program runs in float32.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12


class OpCost(NamedTuple):
    name: str
    flops: int
    stream_bytes: int
    gather_rows: int


def nnz(kernel_map) -> int:
    """Present entries (>= 0) of a map, numpy or torch."""
    return 0 if kernel_map is None else int((kernel_map >= 0).sum())


def _conv_cost(name, pairs, n_in, n_out, cin, cout, k_vol,
               dtype_bytes=4) -> OpCost:
    return OpCost(
        name=name,
        flops=2 * pairs * cin * cout,
        stream_bytes=(n_in * cin + n_out * cout) * dtype_bytes
        + k_vol * cin * cout * dtype_bytes,
        gather_rows=pairs if k_vol > 1 else 0,
    )


def _bn_relu_cost(name, n, c, dtype_bytes=4) -> OpCost:
    return OpCost(name, flops=0, stream_bytes=2 * n * c * dtype_bytes,
                  gather_rows=0)


class LevelCounts(NamedTuple):
    """What ``backbone_costs`` reads of one pyramid level."""
    n: int             # valid rows
    k3: int            # present k3 pairs
    k5: int            # present k5 pairs (level 0)
    down: int          # present down pairs into the next level
    up: int            # rows with a parent


def level_counts(levels) -> list[LevelCounts]:
    """From a padded pyramid's levels (fields ``num_valid``, ``k3``,
    ``k5``, ``down``, ``up_parent``), numpy or torch."""
    return [LevelCounts(int(l.num_valid), nnz(l.k3), nnz(l.k5),
                        nnz(l.down), nnz(l.up_parent)) for l in levels]


def backbone_costs(lv: list[LevelCounts], bb: dict,
                   dtype_bytes: int = 4) -> list[OpCost]:
    """Per-op useful costs of the Res16UNet (basic blocks) on one
    pyramid, stage by stage."""
    planes, layers, d0 = bb["planes"], bb["layers"], bb["init_dim"]
    n = [l.n for l in lv]
    k3_nnz = [l.k3 for l in lv]
    costs: list[OpCost] = []
    kvol = bb["conv1_kernel_size"] ** 3
    costs.append(_conv_cost("stem/conv0p1s1", lv[0].k5, n[0], n[0],
                            bb["in_channels"], d0, kvol, dtype_bytes))
    costs.append(_bn_relu_cost("stem/bn0+relu", n[0], d0, dtype_bytes))

    def block_costs(tag, level, cin, p, num_blocks):
        out: list[OpCost] = []
        pairs, nn = k3_nnz[level], n[level]
        ch_in = cin
        for b in range(num_blocks):
            out.append(_conv_cost(f"{tag}/b{b}/conv1", pairs, nn, nn,
                                  ch_in, p, 27, dtype_bytes))
            out.append(_conv_cost(f"{tag}/b{b}/conv2", pairs, nn, nn,
                                  p, p, 27, dtype_bytes))
            if ch_in != p:
                out.append(_conv_cost(f"{tag}/b{b}/downsample", nn, nn, nn,
                                      ch_in, p, 1, dtype_bytes))
            out.append(_bn_relu_cost(f"{tag}/b{b}/bn+relu", nn, 2 * p,
                                     dtype_bytes))
            ch_in = p
        return out

    down_in = d0
    for i in range(4):
        costs.append(_conv_cost(f"down{i+1}/conv", lv[i].down, n[i],
                                n[i + 1], down_in, down_in, 8, dtype_bytes))
        costs.append(_bn_relu_cost(f"down{i+1}/bn+relu", n[i + 1], down_in,
                                   dtype_bytes))
        costs.extend(block_costs(f"down{i+1}/block{i+1}", i + 1, down_in,
                                 planes[i], layers[i]))
        down_in = planes[i]
    skips = [planes[2], planes[1], planes[0], d0]
    tr_in = planes[3]
    for j in range(4):
        i, tgt = 4 + j, 3 - j
        costs.append(_conv_cost(f"up{i}/convtr", lv[tgt].up, n[tgt + 1],
                                n[tgt], tr_in, planes[i], 8, dtype_bytes))
        costs.append(_bn_relu_cost(f"up{i}/bn+relu", n[tgt], planes[i],
                                   dtype_bytes))
        cat_ch = planes[i] + skips[j]
        costs.append(OpCost(f"up{i}/concat", 0,
                            n[tgt] * cat_ch * dtype_bytes, 0))
        costs.extend(block_costs(f"up{i}/block{i+1}", tgt, cat_ch,
                                 planes[i], layers[i]))
        tr_in = planes[i]
    return costs


def decoder_costs(n: int, q: int, dec: dict,
                  dtype_bytes: int = 4) -> list[OpCost]:
    """Per-component costs of one decoder pass (all refinement rounds)
    over n voxels and q queries (background + clicks)."""
    c, f = dec["hidden_dim"], dec["dim_feedforward"]
    rounds = dec["num_decoders"] * len(dec["hlevels"])
    ds = dtype_bytes
    costs: list[OpCost] = []
    for r in range(rounds):
        costs.append(OpCost(
            f"r{r}/c2s",
            flops=2 * (q * c * c * 2 + n * c * c * 2) + 4 * q * n * c,
            stream_bytes=(2 * n * c * 2 + q * c * 2) * ds, gather_rows=0))
        costs.append(OpCost(
            f"r{r}/c2c", flops=2 * q * c * c * 4 + 4 * q * q * c,
            stream_bytes=3 * q * c * ds, gather_rows=0))
        costs.append(OpCost(
            f"r{r}/ffn", flops=2 * q * c * f * 2,
            stream_bytes=3 * q * c * ds, gather_rows=0))
        costs.append(OpCost(
            f"r{r}/s2c",
            flops=2 * (n * c * c * 2 + q * c * c * 2) + 4 * n * q * c,
            stream_bytes=(3 * n * c * 2) * ds, gather_rows=0))
        n_cols = 1 + dec["max_fg_objects"]
        costs.append(OpCost(
            f"r{r}/mask_head",
            flops=2 * q * c * c * 2 + 2 * n * q * c,
            stream_bytes=(n * c + n * q + n * n_cols) * ds, gather_rows=0))
    return costs


def decoder_flops(n: int, q: int, dec: dict) -> int:
    return sum(c.flops for c in decoder_costs(n, q, dec))


def backbone_flops(lv: list[LevelCounts], bb: dict) -> int:
    return sum(c.flops for c in backbone_costs(lv, bb))
