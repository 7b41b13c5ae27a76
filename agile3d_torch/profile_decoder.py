"""Where the time of one decoder pass goes on the card:
``python -m agile3d_torch.profile_decoder [--out FILE]``.

Builds the smoke scene of ``chip_smoke.py`` (400,000 synthetic points, 8
objects, the 196,608-row bucket) at full width with seeded random weights,
runs the backbone once, then traces ``forward_mask`` with one click per
object and the background (the 32-slot click table) four ways: dense and
chunked attention (the chunk JAX's rule picks), each in f32 and under the
bf16 policy. Prints one JSON line per form: the host-clock ms of the
traced pass, the span from its first kernel to its last, the summed device
ms and its share of that span, the kernel launches, the kernels with
the most device time and the matrix products by operand shapes (``--out`` also gets the profiler's tables). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from agile3d_torch.config import Config
from agile3d_torch.data.datasets import InterMultiObjDataset, collate_scenes
from agile3d_torch.data.synthetic import write_benchmark
from agile3d_torch.engine.eval import InteractiveEngine, resolve_device
from agile3d_torch.models.agile3d import ClickState, init_agile3d

SCENE = dict(num_scenes=1, num_obj=8, n_points=400000, extent=8.0, seed=0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="file for the profiler tables")
    p.add_argument("--top", default=12, type=int)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        scans, lst = write_benchmark(tmp, **SCENE)
        batch = collate_scenes(
            [InterMultiObjDataset(scans, lst, cfg.model.voxel_size)[0]],
            cfg.buckets)
    model = init_agile3d(cfg.model, seed=0, device="cpu")
    engine = InteractiveEngine(cfg, model, device)
    scene = engine.run_backbone(batch)
    n_valid = int((batch.sample_idx[0] >= 0).sum())
    labels = batch.labels[0, :n_valid]
    num_obj = int(batch.num_obj[0])
    vox = [int((labels == o).nonzero()[0][0]) for o in range(num_obj + 1)]
    mc = InteractiveEngine.CLICK_BUCKETS[0]
    t = lambda v: torch.tensor([v], dtype=torch.int32, device=device)
    clicks = ClickState(t(vox + [-1] * (mc - len(vox))),
                        t(list(range(num_obj + 1)) + [0] * (mc - len(vox))),
                        t(list(range(mc))))
    no = torch.tensor([num_obj], dtype=torch.int32, device=device)
    bf16_scene = scene._replace(mask_feat=scene.mask_feat.to(torch.bfloat16),
                                pos_pcd=scene.pos_pcd.to(torch.bfloat16))

    tables = []
    for dtype in ("float32", "bfloat16"):
        for form, threshold in (("dense", 2 ** 62),
                                ("chunked", cfg.model.attn_dense_threshold)):
            model.cfg = dataclasses.replace(cfg.model, decoder_dtype=dtype,
                                            attn_dense_threshold=threshold)
            sc = scene if dtype == "float32" else bf16_scene
            with torch.no_grad():
                for _ in range(2):  # warm-up
                    out = model.forward_mask(sc, clicks, no)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    t0 = time.perf_counter()
                    model.forward_mask(sc, clicks, no)
                    torch.cuda.synchronize()
                    host_ms = 1e3 * (time.perf_counter() - t0)
            # the device's own events (kernels, copies)
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in events) / 1e3
            kernel_spans = [e for e in prof.events()
                            if e.device_type == DeviceType.CUDA]
            wall_ms = (max(e.time_range.end for e in kernel_spans)
                       - min(e.time_range.start for e in kernel_spans)) / 1e3
            events.sort(key=lambda e: -e.self_device_time_total)
            # the matrix products by operand shapes, with their kernels' time
            products = sorted(
                (e for e in prof.key_averages(group_by_input_shape=True)
                 if e.key in ("aten::bmm", "aten::mm", "aten::addmm")),
                key=lambda e: -e.device_time_total)
            row = {"form": form, "dtype": dtype, "chunk": out["attn_chunk"],
                   "device": torch.cuda.get_device_name(0),
                   "rows": scene.mask_feat.shape[1], "queries":
                   cfg.model.num_bg_queries + mc,
                   "host_ms": host_ms, "device_span_ms": wall_ms,
                   "device_busy_ms": device_ms,
                   "busy_share": device_ms / wall_ms,
                   "launches": sum(e.count for e in events),
                   "top": [{"name": e.key[:90], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in events[:args.top]],
                   "products": [{"op": e.key, "shapes": e.input_shapes,
                                 "calls": e.count,
                                 "device_ms": e.device_time_total / 1e3}
                                for e in products[:args.top]]}
            print(json.dumps(row), flush=True)
            tables.append(f"== {form} {dtype}\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
