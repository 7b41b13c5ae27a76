"""The interactive annotation tool: ``python -m agile3d_torch.run_ui``.

Serves the scenes of ``--dataset_scenes`` (one ``scene_<name>/`` folder
each, ``interactive/dataloader.py``) through
``InteractiveSegmentationServer`` on the card (``--device cuda``, the
default). Clients:

  default     the browser viewer (``interactive/web.py``) at --host:--port
  --terminal  a REPL taking ``<obj_id> <x> <y> <z>`` clicks

The decoder runs in bf16 by default (``--decoder_dtype``), as the JAX
package serves; float32 is the eval CLIs' default. Takes every flag of
the JAX package's ``run_ui.py``, the reference model block among them
(``cli.py``). ``--pretraining_weights`` takes a reference ``.pth``;
without one (the default: the released ``checkpoint1099.pth`` is not in
the repository) the weights are random, drawn from ``--seed``. A scene
over the card's memory exits with one ``error:`` line.
"""

from __future__ import annotations

import argparse

import numpy as np

from agile3d_torch.cli import (
    add_reference_model_flags,
    device_arg,
    model_config_from_args,
    run,
)
from agile3d_torch.config import Config
from agile3d_torch.interactive import (
    InteractiveDataLoader,
    InteractiveSegmentationServer,
)


def get_args_parser():
    p = argparse.ArgumentParser("AGILE3D interactive tool")
    p.add_argument("--user_name", default="user", type=str)
    p.add_argument("--pretraining_weights", default="", type=str,
                   help="reference .pth; empty (the default, since "
                        "checkpoint1099.pth is not in the repository) = "
                        "random weights from --seed")
    p.add_argument("--dataset_scenes", default="data/interactive_dataset",
                   type=str)
    p.add_argument("--point_type", default=None, type=str,
                   help="accepted for reference scripts; unused")
    add_reference_model_flags(p)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--decoder_dtype", default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--terminal", action="store_true",
                   help="terminal REPL instead of the web viewer")
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8008, type=int)
    return p


def terminal_loop(server: InteractiveSegmentationServer, read=input,
                  write=print):
    click_idx, click_time_idx, t = {"0": []}, {"0": []}, 0
    write(f"scene: {server.sample.scene_name} ({server.n_valid} voxels). "
          f"Commands: '<obj_id> <x> <y> <z>' to click, 'next'/'prev' "
          f"scene, 'quit'.")
    while True:
        try:
            line = read("> ").strip()
        except EOFError:
            break
        if line in ("quit", "q"):
            break
        if line in ("next", "prev"):
            name = (server.next_scene() if line == "next"
                    else server.previous_scene())
            write(f"scene: {name}" if name else "no more scenes")
            click_idx, click_time_idx, t = {"0": []}, {"0": []}, 0
            continue
        try:
            parts = line.split()
            obj_id, xyz = parts[0], np.asarray(list(map(float, parts[1:4])))
            if len(xyz) != 3:
                raise ValueError(line)
        except (ValueError, IndexError):
            write("expected: <obj_id> <x> <y> <z>")
            continue
        vox = server.nearest_voxel(xyz)
        click_idx.setdefault(obj_id, []).append(vox)
        click_time_idx.setdefault(obj_id, []).append(t)
        t += 1
        _, iou = server.get_next_click(click_idx, click_time_idx)
        write(f"clicks: {t}, mIoU: "
              f"{'NA' if iou is None else round(iou * 100, 1)}")


def main(args):
    cfg = Config(model=model_config_from_args(
        args, decoder_dtype=args.decoder_dtype))
    loader = InteractiveDataLoader(args.dataset_scenes, args.user_name)
    server = InteractiveSegmentationServer(
        loader, weights=args.pretraining_weights or None, cfg=cfg,
        device=device_arg(args), seed=args.seed)
    if args.terminal:
        terminal_loop(server)
    else:
        from agile3d_torch.interactive.web import serve

        serve(server, host=args.host, port=args.port)
    return server


if __name__ == "__main__":
    run(get_args_parser(), main)
