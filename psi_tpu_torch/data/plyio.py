"""Minimal PLY mesh reader (vertices + triangular faces).

Copied from ``psi_tpu.data.plyio`` (numpy only).

Fallback for environments without open3d (the reference uses
o3d.io.read_triangle_mesh, batch_gen_hdf5.py:144). Supports ascii and
binary_little_endian PLY with float vertex properties x, y, z and
uchar-count int vertex_indices face lists — the format of the PROX
``scenes_downsampled/*.ply`` assets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8), "float64": ("f8", 8),
    "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4), "uint32": ("u4", 4),
    "short": ("i2", 2), "ushort": ("u2", 2), "char": ("i1", 1), "uchar": ("u1", 1),
    "int8": ("i1", 1), "uint8": ("u1", 1), "int16": ("i2", 2), "uint16": ("u2", 2),
}


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertices [V, 3] float64, faces [F, 3] int32)."""
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(type, name) ...] or ('list', count_t, item_t, name))
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = {"name": tok[1], "count": int(tok[2]), "props": []}
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur["props"].append(("list", tok[2], tok[3], tok[4]))
            else:
                cur["props"].append((tok[1], tok[2]))

    verts = None
    faces = None

    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for el in elements:
            rows = []
            for _ in range(el["count"]):
                while not lines[li].strip():
                    li += 1
                rows.append(lines[li].strip().split())
                li += 1
            if el["name"] == "vertex":
                names = [p[1] for p in el["props"]]
                ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                verts = np.array([[float(r[ix]), float(r[iy]), float(r[iz])] for r in rows])
            elif el["name"] == "face":
                faces = np.array([[int(v) for v in r[1:4]] for r in rows], dtype=np.int32)
        return verts, faces if faces is not None else np.zeros((0, 3), np.int32)

    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")

    offset = 0
    for el in elements:
        if el["name"] == "vertex":
            names = [p[1] for p in el["props"]]
            dtypes = [(p[1], "<" + _DTYPES[p[0]][0]) for p in el["props"]]
            rec = np.dtype(dtypes)
            arr = np.frombuffer(body, dtype=rec, count=el["count"], offset=offset)
            offset += rec.itemsize * el["count"]
            verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float64)
        elif el["name"] == "face":
            # assume uniform triangles: count_type then 3 indices
            p = el["props"][0]
            cnt_t, item_t = _DTYPES[p[1]], _DTYPES[p[2]]
            rec = np.dtype([("n", "<" + cnt_t[0]), ("v", "<" + item_t[0], (3,))])
            arr = np.frombuffer(body, dtype=rec, count=el["count"], offset=offset)
            offset += rec.itemsize * el["count"]
            faces = arr["v"].astype(np.int32)
        else:  # skip unknown fixed-size elements
            size = sum(_DTYPES[p[0]][1] for p in el["props"] if p[0] != "list")
            offset += size * el["count"]
    return verts, faces if faces is not None else np.zeros((0, 3), np.int32)
