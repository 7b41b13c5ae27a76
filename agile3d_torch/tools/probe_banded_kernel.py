"""Probe: the windowed banded k3 conv against the shipped gathered one.

Counterpart of ``tools/probe_banded_kernel.py``, whose TPU kernel DMAs a
window of sorted rows into VMEM per 128-row block and gathers from it with
one-hot band matmuls. Here ``ops/banded_window.py`` copies each
(block, dx-cluster) window into shared memory and gathers by row address,
while ``banded_conv`` (the kernel the eval and training paths run) gathers
every neighbour row from device memory. On the TPU probe's scene (400,000
points, level 0) and shape (96 -> 96) it prints the plan's window
statistics, whether the plan covers every present neighbour, and the times
of the window kernel, ``banded_conv`` and the plain version.

    python -m agile3d_torch.tools.probe_banded_kernel [--points N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from agile3d_torch.ops.banded_conv import banded_conv
from agile3d_torch.ops.banded_window import (
    banded_window_conv,
    banded_window_conv_reference,
    max_window_rows,
    window_plan,
    window_stats,
    window_work,
)
from agile3d_torch.tools import (
    bound_ms,
    device_label,
    probe_scene,
    resolve_device,
    time_ms,
)

CIN = COUT = 96  # the TPU probe's shape


def run(k3: np.ndarray, cin: int, cout: int, device, generator,
        log=print) -> dict:
    """Plan the map k3 [N, 27] (host, int32) for windows that fit the
    kernel's shared memory at cin -> cout, then time the window kernel,
    ``banded_conv`` and the plain window conv on seeded random x and w on
    ``device`` (``generator`` lives there). Returns the numbers printed."""
    device = torch.device(device)
    n, k = k3.shape
    plan = window_plan(k3, max_rows=max_window_rows(k, cout))
    stats = window_stats(k3, plan)
    per = ", ".join(f"{s['p50']:.0f}/{s['p99']:.0f}/{s['max']}"
                    for s in stats["windows"])
    log(f"plan: {stats['blocks']} blocks of {plan.block_m} rows; window rows "
        f"per cluster p50/p99/max {per}; {stats['window_rows']} window rows "
        f"against {stats['present']} present neighbours "
        f"({stats['row_ratio']:.2f}x fewer); covers every present "
        f"neighbour: {plan.covers}")

    nbr = torch.from_numpy(np.ascontiguousarray(k3)).to(device)
    plan_d = plan.to(device)
    x = torch.randn((n, cin), generator=generator, device=device)
    w = torch.randn((k, cin, cout), generator=generator, device=device) * 0.05
    y = banded_window_conv(x, nbr, plan_d, w)
    ref = banded_window_conv_reference(x, nbr, plan_d, w)
    err = float((y - ref).abs().max())
    ref_max = float(ref.abs().max())

    on = device_label(device)
    res = {"rows": n, "cin": cin, "cout": cout, "covers": plan.covers,
           "plan": stats, "max_abs_err": err, "ref_max": ref_max,
           "device": on}
    for key, fn in (("window_ms", lambda: banded_window_conv(x, nbr, plan_d, w)),
                    ("banded_conv_ms", lambda: banded_conv(x, nbr, w)),
                    ("plain_ms", lambda: banded_window_conv_reference(
                        x, nbr, plan_d, w))):
        res[key] = time_ms(fn, device)
    res["bound_ms"], res["bound_by"] = bound_ms(*window_work(nbr, plan_d, cin,
                                                             cout))
    log(f"k3 {n} rows {cin}->{cout} on {on}: window kernel "
        f"{res['window_ms']:.4f} ms, banded_conv {res['banded_conv_ms']:.4f} "
        f"ms, plain {res['plain_ms']:.4f} ms; H100 bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}); max|window - plain| "
        f"{err:.3g} (plain max {ref_max:.3g})")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=400000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lvl = probe_scene(args.points).levels[0]
    print(f"scene: {lvl.num_valid} voxels, bucket {lvl.k3.shape[0]}",
          flush=True)
    return run(lvl.k3, CIN, COUT, device,
               torch.Generator(device=device).manual_seed(0))


if __name__ == "__main__":
    main()
