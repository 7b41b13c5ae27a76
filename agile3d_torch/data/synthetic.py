"""Synthetic scenes in the AGILE3D scan format (PLY with x, y, z, R, G, B,
label plus a val-list json). The same numpy draws as
the JAX package's ``data/synthetic.py``, so one seed gives the same files."""

import json
import os

import numpy as np

from agile3d_torch.data.ply import write_ply


def make_scene(rng, n_points=4000, num_obj=3, extent=4.0):
    """Box room with ``num_obj`` spherical objects on a floor."""
    n_bg = n_points // 2
    bg = rng.random((n_bg, 3)).astype(np.float32) * extent
    bg[:, 2] *= 0.05  # floor
    labels = [np.zeros(n_bg, np.int32)]
    pts = [bg]
    n_per = (n_points - n_bg) // num_obj
    for o in range(1, num_obj + 1):
        center = rng.random(3).astype(np.float32) * (extent * 0.7) + extent * 0.15
        center[2] = 0.5
        blob = center + rng.standard_normal((n_per, 3)).astype(np.float32) * 0.25
        pts.append(blob.astype(np.float32))
        labels.append(np.full(n_per, o, np.int32))
    coords = np.vstack(pts)
    labels = np.concatenate(labels)
    colors = (rng.random((len(coords), 3)) * 255).astype(np.uint8)
    return coords, colors, labels


def write_benchmark(tmpdir, num_scenes=2, num_obj=3, seed=0, n_points=4000,
                    extent=4.0):
    """Write scans + val list in the reference's layout; returns
    (scan_folder, val_list_path). Labels are 1..num_obj already, so the
    val list's object map is the identity."""
    rng = np.random.default_rng(seed)
    scans = os.path.join(tmpdir, "scans")
    os.makedirs(scans, exist_ok=True)
    val_list = {}
    for i in range(num_scenes):
        name = f"scene{i:04d}_00"
        coords, colors, labels = make_scene(rng, n_points=n_points,
                                            num_obj=num_obj, extent=extent)
        write_ply(os.path.join(scans, name + ".ply"), {
            "x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
            "R": colors[:, 0], "G": colors[:, 1], "B": colors[:, 2],
            "label": labels,
        })
        val_list[f"{name}_obj_{num_obj}"] = {
            "obj": {str(o): o for o in range(1, num_obj + 1)},
            "clicks": {},
        }
    list_path = os.path.join(tmpdir, "val_list.json")
    with open(list_path, "w") as f:
        json.dump(val_list, f)
    return scans, list_path
