"""Analytic operation, byte and row counts of the model (counterpart of the
JAX package's ``utils/costs.py``), and the eval footprint estimate behind
the oversize guard (``engine/eval.py::check_single_chip_rows``).

The counts walk the real kernel maps, so they follow the scene's sparse
topology; they depend on the model and the scene only, and equal the JAX
package's integer for integer:

  flops          2 * pairs * cin * cout per sparse conv, 2 * M * N * K
                 per matmul
  stream_bytes   every input read once and every output written once
                 (and the weights): the bandwidth roofline's bytes
  gather_rows    rows gathered by neighbour index (the sparse convs' pairs)

Peaks: one NVIDIA H100 SXM's data-sheet figures, the ones ``chip_smoke.py``
uses: 989e12 dense bf16 tensor-core FLOP/s and 3.35e12 B/s of HBM3. The
share of the tensor-core peak that a measured time reaches is ``mfu``.

The JAX module's HBM-granule model (``GRANULE_RATE``,
``gather_model_s``, the ``gather_model_ms`` keys) is left out: it is a
TPU v5e measurement of random gathers in ~512 B transactions, with no
counterpart measured on the H100.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from agile3d_torch.config import BackboneConfig, ModelConfig

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12

# The card's memory: torch.cuda.get_device_properties(0).total_memory of an
# NVIDIA H100 80GB HBM3, 85,017,493,504 bytes (chip_smoke.py, memory
# phase), in GiB.
SINGLE_CHIP_HBM_GIB = 85_017_493_504 / 2**30
# Device bytes per padded level-0 row of eval at Res16UNet34C width: the
# footprint of one forward_backbone and one forward_mask (the peak of
# torch.cuda.max_memory_allocated less what was held before the model was
# built: weights, inputs and the passes' tensors) was 5,625 B per row at
# the 196,608-row bucket and 4,623 at 786,432 (chip_smoke.py's memory phase
# on an NVIDIA H100 80GB HBM3, 700 W), rounded up to 8 KiB so the estimate
# stays above both; that phase checks it on every run.
EVAL_BYTES_PER_ROW = 8 * 1024


def eval_hbm_gib(n_rows: int) -> float:
    """Estimated peak device footprint (GiB) of eval at a padded level-0
    row count: linear in rows (``EVAL_BYTES_PER_ROW``)."""
    return n_rows * EVAL_BYTES_PER_ROW / 2**30


class OpCost(NamedTuple):
    name: str
    flops: int
    stream_bytes: int
    gather_rows: int

    def roofline_s(self) -> float:
        """The card's least time for this op: the larger of its operations
        at the bf16 tensor-core peak and its compulsory bytes at the HBM
        rate."""
        return max(self.flops / PEAK_BF16_FLOPS,
                   self.stream_bytes / PEAK_HBM_BPS)


def _nnz(kernel_map) -> int:
    return 0 if kernel_map is None else int((np.asarray(kernel_map) >= 0).sum())


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
    # read + write the activations once (BN and ReLU in one pass)
    return OpCost(name, flops=0, stream_bytes=2 * n * c * dtype_bytes,
                  gather_rows=0)


def backbone_costs(pyr, cfg: BackboneConfig = BackboneConfig(),
                   dtype_bytes: int = 4, padded: bool = False) -> list[OpCost]:
    """Per-op costs of the backbone on this scene's padded pyramid (host
    numpy arrays or tensors), stage by stage as ``models/backbone.py``
    runs it: the stem, 4 x (k2 s2 down conv + stage), 4 x (k2 s2
    transposed conv + skip concat + stage); pairs from the maps.

    padded=False counts useful work (valid rows and present neighbours),
    the numerator of ``mfu``; padded=True counts every padded row times
    every offset, what a dense gather-GEMM over the bucket issues."""
    lv = pyr.levels
    planes, layers, d0, exp = cfg.planes, cfg.layers, cfg.init_dim, cfg.expansion
    if padded:
        n = [l.grid.shape[0] for l in lv]
        k3_nnz = [27 * nn for nn in n]
    else:
        n = [l.num_valid for l in lv]
        k3_nnz = [_nnz(l.k3) for l in lv]
    costs: list[OpCost] = []

    kvol = cfg.conv1_kernel_size ** 3
    stem_pairs = kvol * n[0] if padded else _nnz(lv[0].k5)
    costs.append(_conv_cost("stem/conv0p1s1", stem_pairs, n[0], n[0],
                            cfg.in_channels, d0, kvol, dtype_bytes))
    costs.append(_bn_relu_cost("stem/bn0+relu", n[0], d0, dtype_bytes))

    def block_costs(tag, level, cin, p, num_blocks, block):
        out: list[OpCost] = []
        pairs = k3_nnz[level]
        nn = n[level]
        ch_in = cin
        exp_out = p * (4 if block == "bottleneck" else 1)
        for b in range(num_blocks):
            if block == "bottleneck":
                out.append(_conv_cost(f"{tag}/b{b}/conv1x1a", nn, nn, nn,
                                      ch_in, p, 1, dtype_bytes))
                out.append(_conv_cost(f"{tag}/b{b}/conv3", pairs, nn, nn,
                                      p, p, 27, dtype_bytes))
                out.append(_conv_cost(f"{tag}/b{b}/conv1x1b", nn, nn, nn,
                                      p, exp_out, 1, dtype_bytes))
            else:
                out.append(_conv_cost(f"{tag}/b{b}/conv1", pairs, nn, nn,
                                      ch_in, p, 27, dtype_bytes))
                out.append(_conv_cost(f"{tag}/b{b}/conv2", pairs, nn, nn,
                                      p, p, 27, dtype_bytes))
            if ch_in != exp_out:
                out.append(_conv_cost(f"{tag}/b{b}/downsample", nn, nn, nn,
                                      ch_in, exp_out, 1, dtype_bytes))
            out.append(_bn_relu_cost(f"{tag}/b{b}/bn+relu", nn,
                                     2 * exp_out, dtype_bytes))
            ch_in = exp_out
        return out

    down_in = d0
    for i in range(4):
        pairs_down = 8 * n[i + 1] if padded else _nnz(lv[i].down)
        costs.append(_conv_cost(f"down{i+1}/conv", pairs_down, n[i],
                                n[i + 1], down_in, down_in, 8, dtype_bytes))
        costs.append(_bn_relu_cost(f"down{i+1}/bn+relu", n[i + 1], down_in,
                                   dtype_bytes))
        costs.extend(block_costs(f"down{i+1}/block{i+1}", i + 1, down_in,
                                 planes[i], layers[i], cfg.block))
        down_in = planes[i] * exp

    skips = [planes[2] * exp, planes[1] * exp, planes[0] * exp, d0]
    tr_in = planes[3] * exp
    for j in range(4):
        i = 4 + j
        tgt = 3 - j
        # transposed conv: one coarse parent per fine voxel (useful); a
        # dense form runs all 8 offsets over every fine row
        pairs_up = (8 * n[tgt] if padded
                    else int((np.asarray(lv[tgt].up_parent) >= 0).sum()))
        costs.append(_conv_cost(f"up{i}/convtr", pairs_up, n[tgt + 1],
                                n[tgt], tr_in, planes[i], 8, dtype_bytes))
        costs.append(_bn_relu_cost(f"up{i}/bn+relu", n[tgt], planes[i],
                                   dtype_bytes))
        cat_ch = planes[i] + skips[j]
        # concat: write the concatenated activations once
        costs.append(OpCost(f"up{i}/concat", 0,
                            n[tgt] * cat_ch * dtype_bytes, 0))
        costs.extend(block_costs(f"up{i}/block{i+1}", tgt, cat_ch,
                                 planes[i], layers[i], cfg.block))
        tr_in = planes[i] * exp

    return costs


def decoder_costs(n: int, q: int, cfg: ModelConfig = ModelConfig(),
                  dtype_bytes: int = 4) -> list[OpCost]:
    """Per-component costs of one ``forward_mask`` (all refinement rounds):
    c2s cross-attention, c2c self-attention, FFN, s2c cross-attention and
    the mask head, num_decoders x len(hlevels) times.

    n = padded voxel count, q = query count (background + click bucket)."""
    c = cfg.hidden_dim
    f = cfg.dim_feedforward
    rounds = cfg.num_decoders * len(cfg.hlevels)
    ds = dtype_bytes
    costs: list[OpCost] = []
    for r in range(rounds):
        # c2s: q/k/v/out projections + QK^T + PV over n keys
        costs.append(OpCost(
            f"r{r}/c2s",
            flops=2 * (q * c * c * 2 + n * c * c * 2) + 4 * q * n * c,
            stream_bytes=(2 * n * c * 2 + q * c * 2) * ds,
            gather_rows=0))
        costs.append(OpCost(
            f"r{r}/c2c", flops=2 * q * c * c * 4 + 4 * q * q * c,
            stream_bytes=3 * q * c * ds, gather_rows=0))
        costs.append(OpCost(
            f"r{r}/ffn", flops=2 * q * c * f * 2,
            stream_bytes=3 * q * c * ds, gather_rows=0))
        # s2c: the n voxels are the queries
        costs.append(OpCost(
            f"r{r}/s2c",
            flops=2 * (n * c * c * 2 + q * c * c * 2) + 4 * n * q * c,
            stream_bytes=(3 * n * c * 2) * ds, gather_rows=0))
        # mask head: 2-layer MLP on queries, [n, q] logits, per-object max
        n_cols = 1 + cfg.max_fg_objects
        costs.append(OpCost(
            f"r{r}/mask_head",
            flops=2 * q * c * c * 2 + 2 * n * q * c,
            stream_bytes=(n * c + n * q + n * n_cols) * ds, gather_rows=0))
    return costs


def summarize(costs: list[OpCost], measured_s: float | None = None) -> dict:
    """Totals and, given a measured time, the rates it implies: achieved
    TFLOP/s and GB/s, ``mfu`` (share of the bf16 tensor-core peak) and
    ``frac_of_roofline`` (the summed per-op least time over the measured
    time)."""
    flops = sum(c.flops for c in costs)
    stream = sum(c.stream_bytes for c in costs)
    rows = sum(c.gather_rows for c in costs)
    t_floor = sum(c.roofline_s() for c in costs)
    out = {
        "model_flops": int(flops),
        "stream_bytes": int(stream),
        "gather_rows": int(rows),
        "roofline_floor_ms": 1e3 * t_floor,
    }
    if measured_s:
        out["achieved_tflops"] = flops / measured_s / 1e12
        out["achieved_gbps"] = stream / measured_s / 1e9
        out["mfu"] = flops / measured_s / PEAK_BF16_FLOPS
        out["frac_of_roofline"] = t_floor / measured_s
    return out


def stage_table(costs: list[OpCost], group=lambda name: name.split("/")[0]):
    """Totals per stage (stem, down1..4, up4..7)."""
    agg: dict[str, list] = {}
    for c in costs:
        a = agg.setdefault(group(c.name), [0, 0, 0, 0.0])
        a[0] += c.flops
        a[1] += c.stream_bytes
        a[2] += c.gather_rows
        a[3] += c.roofline_s()
    return {g: {"gflops": round(v[0] / 1e9, 2),
                "stream_mb": round(v[1] / 1e6, 1),
                "gather_mrows": round(v[2] / 1e6, 2),
                "floor_ms": 1e3 * v[3]}
            for g, v in agg.items()}
