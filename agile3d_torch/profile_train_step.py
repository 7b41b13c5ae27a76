"""Where the time of one training step goes on the card:
``python -m agile3d_torch.profile_train_step [--out FILE]``.

Builds the training batch of ``chip_smoke.py`` (5 synthetic scenes of
~94,000 voxels, the 524,288-row level-0 bucket) at full width with seeded
random weights, rolls out clicks once, then traces one batched rollout
decoder pass, the click simulation of one rollout round (5 samples), the
rollout's backbone and one supervised step (forward, backward, AdamW) with
``torch.profiler``. Prints one JSON line per phase: wall ms, summed device
ms, the device's busy share of the wall time, and the kernels with the
most device time (``--out`` also gets the profiler's tables). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import random
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.clicks import simulate_clicks
from agile3d_torch.engine.eval import InteractiveEngine, resolve_device
from agile3d_torch.engine.train import (
    click_state,
    make_optimizer,
    make_train_step,
    prepare_batch,
    rollout_clicks,
)
from agile3d_torch.models.agile3d import init_agile3d

SCENES = dict(num_scenes=5, num_obj=8, n_points=190000, extent=6.0, seed=2)


def _trace(fn, top: int):
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0)
    # the device's own events (kernels, copies): the operators above them
    # carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in events[:top]]
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "top": rows}, table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="file for the profiler tables")
    p.add_argument("--top", default=15, type=int)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        scans, lst = write_benchmark(tmp, **SCENES)
        ds = InterMultiObjDataset(scans, lst, cfg.model.voxel_size)
        batch, labels, num_obj, n_valid = prepare_batch(
            ds, range(len(ds)), cfg, seed=0)
    model = init_agile3d(cfg.model, seed=0, device="cpu")
    engine = InteractiveEngine(cfg, model, device)
    opt, _ = make_optimizer(engine.model, cfg, 1)
    step = make_train_step(cfg, engine.model, opt)

    scene = engine.run_backbone(batch, training=True)
    raw, off = [], 0
    for n in n_valid:
        raw.append(batch.raw[off: off + n])
        off += n
    clicks = rollout_clicks(engine, scene, labels, num_obj, raw, n_valid,
                            random.Random(0), cfg)
    args_step = (engine.device_batch(batch),
                 click_state(clicks, cfg.model.max_clicks, device),
                 torch.from_numpy(labels).to(device),
                 torch.from_numpy(num_obj).to(device))
    step(*args_step)  # warm-up

    out = {"device": torch.cuda.get_device_name(0),
           "rows": [lv.grid.shape[0] for lv in batch.pyramid.levels],
           "clicks": [c.count for c in clicks]}
    pred = engine.run_mask_batch(scene, clicks, num_obj).cpu().numpy()

    def simulate():
        for i, n in enumerate(n_valid):
            simulate_clicks(pred[i, :n].astype(np.int32), labels[i, :n],
                            raw[i], num_obj=int(num_obj[i]), training=True,
                            current_num_clicks=1, rng=random.Random(i),
                            device=device,
                            max_label=cfg.model.max_fg_objects)

    tables = []
    for name, fn in (
            ("rollout_decoder_pass",
             lambda: engine.run_mask_batch(scene, clicks, num_obj)),
            ("click_simulation", simulate),
            ("rollout_backbone", lambda: engine.run_backbone(batch, True)),
            ("supervised_step", lambda: step(*args_step))):
        res, table = _trace(fn, args.top)
        print(json.dumps({"phase": name, **out, **res}), flush=True)
        tables.append(f"== {name}\n{table}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
