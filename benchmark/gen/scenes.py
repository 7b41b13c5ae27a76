"""Synthetic scenes and the files the program reads them from (numpy only).

Frozen copies, so that the yardstick does not move when the program does:

  * ``make_scene``        agile3d_torch/data/synthetic.py @ f6162fe
  * ``write_ply``         agile3d_torch/data/ply.py @ f6162fe
  * ``noisy_scene``       agile3d_torch/bench.py::noisy_scene @ f6162fe
                          (the noise is the configuration's, 0.03 m there)
  * ``stress_scene``      agile3d_torch/tools/stress_kitti.py @ f6162fe,
                          with the generator passed in instead of rng(0)
  * ``write_scan_list``   agile3d_torch/data/synthetic.py::write_benchmark
                          @ f6162fe, generalised to a list of scenes

A scene is drawn from one ``numpy.random.Generator``: the point counts are
fixed by the configuration, so every seed gives the same sizes and the same
row bucket; the seed moves positions, objects and colours only.
"""

from __future__ import annotations

import json
import os

import numpy as np

_INV_DTYPES = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


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


def noisy_scene(rng, n_points, num_obj, extent, noise):
    """``make_scene`` with Gaussian noise of ``noise`` metres on every
    coordinate (``bench.py``'s serving scene at 0.03, ``stress_kitti``'s
    outdoor scene at 0.04); ``noise`` 0 is ``make_scene`` itself."""
    coords, colors, labels = make_scene(rng, n_points=n_points,
                                        num_obj=num_obj, extent=extent)
    if noise:
        coords += rng.standard_normal(coords.shape).astype(np.float32) * noise
    return coords, colors, labels


def scene_from(spec: dict, rng):
    """A scene of a configuration's scene spec ``{"points", "extent",
    "objects", "noise"}``."""
    return noisy_scene(rng, int(spec["points"]), int(spec["objects"]),
                       float(spec["extent"]), float(spec["noise"]))


def write_ply(path: str, fields: dict) -> None:
    """Write vertex properties (dict name->1D array, equal lengths) as a
    binary little-endian PLY."""
    names = list(fields)
    n = len(fields[names[0]])
    cols = {k: np.asarray(v) for k, v in fields.items()}
    for k, v in cols.items():
        if len(v) != n:
            raise ValueError(f"field {k} length {len(v)} != {n}")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {_INV_DTYPES[cols[k].dtype.name]} {k}" for k in names]
    header.append("end_header")
    rec = np.zeros(n, np.dtype([(k, "<" + cols[k].dtype.str[1:]) for k in names]))
    for k in names:
        rec[k] = cols[k]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())


def scan_fields(coords, colors, labels) -> dict:
    return {"x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
            "R": colors[:, 0], "G": colors[:, 1], "B": colors[:, 2],
            "label": labels}


def write_scan_list(folder: str, scenes: list, num_obj: int) -> tuple:
    """Scans ``scans/scene%04d_00.ply`` and their list json in the
    reference's layout (labels are 1..num_obj already, so the object map
    is the identity). Returns (scan_folder, list_path)."""
    scans = os.path.join(folder, "scans")
    os.makedirs(scans, exist_ok=True)
    listing = {}
    for i, (coords, colors, labels) in enumerate(scenes):
        name = f"scene{i:04d}_00"
        write_ply(os.path.join(scans, name + ".ply"),
                  scan_fields(coords, colors, labels))
        listing[f"{name}_obj_{num_obj}"] = {
            "obj": {str(o): o for o in range(1, num_obj + 1)}, "clicks": {}}
    list_path = os.path.join(folder, "scene_list.json")
    with open(list_path, "w") as f:
        json.dump(listing, f)
    return scans, list_path


def write_tool_scenes(folder: str, scenes: list) -> str:
    """The annotation tool's layout: ``scene_<name>/scan.ply`` (points and
    colours) and ``label.ply`` (ground truth) per scene."""
    for i, (coords, colors, labels) in enumerate(scenes):
        d = os.path.join(folder, f"scene_{i:04d}")
        os.makedirs(d, exist_ok=True)
        f = scan_fields(coords, colors, labels)
        write_ply(os.path.join(d, "scan.ply"),
                  {k: f[k] for k in ("x", "y", "z", "R", "G", "B")})
        write_ply(os.path.join(d, "label.ply"),
                  {k: f[k] for k in ("x", "y", "z", "label")})
    return folder
