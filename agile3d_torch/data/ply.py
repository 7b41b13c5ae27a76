"""PLY point-cloud I/O (the port's own copy of the JAX package's data/ply.py).

Reads the vertex element of ascii / binary_little_endian /
binary_big_endian files, with arbitrary scalar properties, as a dict of
property-name -> numpy array like the reference reader (the AGILE3D scans
carry x, y, z, R, G, B, label); elements after the vertices (mesh faces)
are not read. Writes binary little-endian vertex files."""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the vertex properties of a PLY file as a dict name->array."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0].decode()
            if key == "format":
                fmt = tokens[1].decode()
            elif key == "element":
                elements.append((tokens[1].decode(), int(tokens[2]), []))
            elif key == "property":
                if tokens[1] == b"list":
                    elements[-1][2].append(
                        (tokens[4].decode(), "list",
                         _PLY_DTYPES[tokens[2].decode()],
                         _PLY_DTYPES[tokens[3].decode()]))
                else:
                    elements[-1][2].append(
                        (tokens[-1].decode(), _PLY_DTYPES[tokens[1].decode()]))
            elif key == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        if not elements or elements[0][0] != "vertex":
            raise ValueError(f"{path}: the first element is not 'vertex'")
        _, count, props = elements[0]
        if any(p[1] == "list" for p in props):
            raise ValueError(f"{path}: list properties on vertices")
        if endian:
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            data = np.frombuffer(f.read(dt.itemsize * count), dt)
        else:
            raw = np.loadtxt([f.readline() for _ in range(count)], ndmin=2)
            dt = np.dtype([(p[0], p[1]) for p in props])
            data = np.zeros(count, dt)
            for i, p in enumerate(props):
                data[p[0]] = raw[:, i]
    return {p[0]: np.ascontiguousarray(data[p[0]]) for p in props}


def write_ply(path: str, fields: dict[str, np.ndarray]) -> None:
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
