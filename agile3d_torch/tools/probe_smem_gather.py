"""Probe: the card's row-gather rate from shared memory, L2 and device
memory.

Counterpart of ``tools/probe_vmem_gather.py``, which asks whether Mosaic
gathers rows from a VMEM-resident table and how fast; the H100's shared
memory plays VMEM's part. Every gather-GEMM conv of the backbone is bound
below by this rate. One line each, with rows/s, GB/s and the card's least
time (each byte read or written once):

  (a) ``smem_row_gather`` (``ops/row_gather.py``) on a table that fits one
      block's shared memory, 384 x 128 f32 (192 KB), with 27 x 1024 random
      indices (the TPU probe's B x K), beside ``torch.index_select`` at the
      same shape;
  (a2) ``smem_row_gather`` at the TPU probe's own table, 4,096 x 128 f32
      (2 MB, spread over a 16-CTA cluster's shared memory);
  (b) ``torch.index_select`` at that table (resident in L2);
  (c) the scene-scale gather: 262,144 random rows of 262,144 x 128 f32;
  (d) ``x[k3]`` of a level-0 map at 96 bf16 channels (-1 picks an appended
      zero row): the gather ``banded_conv`` does, at the maps' locality.

    python -m agile3d_torch.tools.probe_smem_gather [--points N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from agile3d_torch.ops.row_gather import (
    gather_work,
    row_gather_reference,
    smem_row_gather,
)
from agile3d_torch.tools import (
    bound_ms,
    device_label,
    probe_scene,
    resolve_device,
    time_ms,
)

SMEM_ROWS, CHANNELS = 384, 128   # (a): 192 KB of f32
TPU_ROWS = 4096                  # (a2), (b): the TPU probe's table
GATHERS = 27 * 1024              # (a) to (b): the TPU probe's B x K indices
SCENE_ROWS = 262144              # (c)
MAP_CHANNELS = 96                # (d)


def run(k3: np.ndarray, device, generator, log=print) -> dict:
    """Lines (a) to (d) on ``device`` (``generator`` lives there), with the
    level-0 map k3 [N, 27] (host, int32) for (d). Returns the numbers
    printed, and in "a_equal" and "a2_equal" whether the kernel gave
    ``x[idx]`` exactly."""
    device = torch.device(device)
    on = device_label(device)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=device)
    ints = lambda hi, m: torch.randint(0, hi, (m,), generator=generator,
                                       device=device, dtype=torch.int32)
    res = {"device": on}

    def line(key, what, fn, w, c, m, itemsize=4):
        ms = time_ms(fn, device)
        moved = gather_work(w, c, m, itemsize)[1]
        b_ms, _ = bound_ms(*gather_work(w, c, m, itemsize))
        res[key] = {"ms": ms, "rows_per_s": m / ms * 1e3,
                    "gb_per_s": moved / ms / 1e6, "bound_ms": b_ms}
        log(f"{what}: {m} rows x {c} from {w} rows on {on}: {ms:.4f} ms, "
            f"{m / ms / 1e3:.1f} M rows/s, {moved / ms / 1e6:.1f} GB/s; "
            f"H100 bound {b_ms:.4f} ms")

    x = rand(SMEM_ROWS, CHANNELS)
    idx = ints(SMEM_ROWS, GATHERS)
    res["a_equal"] = bool(torch.equal(smem_row_gather(x, idx),
                                      row_gather_reference(x, idx)))
    line("a_kernel", "(a) smem_row_gather", lambda: smem_row_gather(x, idx),
         SMEM_ROWS, CHANNELS, GATHERS)
    line("a_plain", "(a) x[idx] (plain version)",
         lambda: row_gather_reference(x, idx), SMEM_ROWS, CHANNELS, GATHERS)
    line("a_library", "(a) torch.index_select",
         lambda: torch.index_select(x, 0, idx), SMEM_ROWS, CHANNELS, GATHERS)
    log(f"(a) smem_row_gather equals x[idx]: {res['a_equal']}")

    xt = rand(TPU_ROWS, CHANNELS)
    it = ints(TPU_ROWS, GATHERS)
    res["a2_equal"] = bool(torch.equal(smem_row_gather(xt, it),
                                       row_gather_reference(xt, it)))
    line("a2_kernel", "(a2) smem_row_gather, the TPU probe's table",
         lambda: smem_row_gather(xt, it), TPU_ROWS, CHANNELS, GATHERS)
    log(f"(a2) smem_row_gather equals x[idx]: {res['a2_equal']}")
    line("b", "(b) torch.index_select, L2-resident table",
         lambda: torch.index_select(xt, 0, it), TPU_ROWS, CHANNELS, GATHERS)
    del xt, it

    xs = rand(SCENE_ROWS, CHANNELS)
    isc = ints(SCENE_ROWS, SCENE_ROWS)
    line("c", "(c) torch.index_select, scene scale",
         lambda: torch.index_select(xs, 0, isc), SCENE_ROWS, CHANNELS,
         SCENE_ROWS)
    del xs, isc

    n, k = k3.shape
    xk = torch.randn((n + 1, MAP_CHANNELS), generator=generator,
                     device=device).to(torch.bfloat16)
    xk[n] = 0
    nbr = torch.from_numpy(np.ascontiguousarray(k3)).to(device)
    ik = torch.where(nbr >= 0, nbr, n).reshape(-1)
    line("d", "(d) torch.index_select, x[k3] of a level-0 map, bf16",
         lambda: torch.index_select(xk, 0, ik), n + 1, MAP_CHANNELS, n * k,
         itemsize=2)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=400000,
                    help="points of the scene whose level-0 map (d) gathers")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    k3 = probe_scene(args.points).levels[0].k3
    return run(k3, device, torch.Generator(device=device).manual_seed(0))


if __name__ == "__main__":
    main()
