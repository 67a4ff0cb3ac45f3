"""Binary little-endian PLY triangle-mesh loader with a path cache.

Mirrors the reference's strict header expectations
(reference src/geometry/shape/plymesh.rs:49-131): float x/y/z/nx/ny/
nz/u/v vertex properties, `property list uint8 int vertex_indices` faces,
triangles only — but tolerates reordered/missing extra properties and ascii
variants for robustness.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_CACHE: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

_SIZES = {
    "char": 1, "int8": 1, "uchar": 1, "uint8": 1,
    "short": 2, "int16": 2, "ushort": 2, "uint16": 2,
    "int": 4, "int32": 4, "uint": 4, "uint32": 4,
    "float": 4, "float32": 4, "double": 8, "float64": 8,
}
_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path) -> Tuple[np.ndarray, np.ndarray]:
    """→ (indices: (F·3,) int64, vertices: (V, 3) f32). Cached by path
    (the reference keeps a global lazy_static cache, plymesh.rs:10-26)."""
    key = str(Path(path).resolve())
    if key in _CACHE:
        return _CACHE[key]

    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    body = raw[end:]

    assert header[0].strip() == "ply", "not a ply file"
    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) or ('list', ct, it, name)])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    if fmt == "ascii":
        return _load_ascii(key, body, elements)
    assert fmt == "binary_little_endian", f"unsupported ply format {fmt}"

    off = 0
    vertices = None
    indices = []
    for name, count, props in elements:
        if name == "vertex":
            fields = [(p[1], _NP[p[0]]) for p in props if p[0] != "list"]
            dt = np.dtype([(n, "<" + t) for n, t in fields])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            vertices = np.stack(
                [arr["x"], arr["y"], arr["z"]], axis=-1
            ).astype(np.float32)
        elif name == "face":
            (tag, ct, it, _pname) = props[0]
            assert tag == "list"
            ct_size, it_size = _SIZES[ct], _SIZES[it]
            it_np = np.dtype("<" + _NP[it])
            ct_np = np.dtype("<" + _NP[ct])
            for _ in range(count):
                n = int(np.frombuffer(body, dtype=ct_np, count=1, offset=off)[0])
                off += ct_size
                idx = np.frombuffer(body, dtype=it_np, count=n, offset=off)
                off += it_size * n
                if n == 3:
                    indices.extend(int(i) for i in idx)
                else:  # fan-triangulate
                    for k in range(1, n - 1):
                        indices.extend((int(idx[0]), int(idx[k]), int(idx[k + 1])))
        else:
            # skip unknown fixed-size elements
            row = sum(_SIZES[p[0]] for p in props if p[0] != "list")
            off += row * count

    result = (np.asarray(indices, np.int64), vertices)
    _CACHE[key] = result
    return result


def _load_ascii(key, body, elements):
    toks = body.decode("ascii").split()
    pos = 0
    vertices = None
    indices = []
    for name, count, props in elements:
        if name == "vertex":
            names = [p[1] for p in props if p[0] != "list"]
            rows = []
            for _ in range(count):
                vals = toks[pos : pos + len(names)]
                pos += len(names)
                rows.append([float(v) for v in vals])
            arr = np.asarray(rows, np.float32)
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            vertices = arr[:, [xi, yi, zi]]
        elif name == "face":
            for _ in range(count):
                n = int(toks[pos]); pos += 1
                idx = [int(t) for t in toks[pos : pos + n]]
                pos += n
                if n == 3:
                    indices.extend(idx)
                else:
                    for k in range(1, n - 1):
                        indices.extend((idx[0], idx[k], idx[k + 1]))
    result = (np.asarray(indices, np.int64), vertices)
    _CACHE[key] = result
    return result


def write_ply(path, indices: np.ndarray, vertices: np.ndarray) -> None:
    """Writer matching the reference's expected layout (for test fixtures)."""
    v = np.asarray(vertices, np.float32)
    idx = np.asarray(indices, np.int32).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(v))
        for p in ("x", "y", "z", "nx", "ny", "nz", "u", "v"):
            f.write(b"property float %s\n" % p.encode())
        f.write(b"element face %d\n" % len(idx))
        f.write(b"property list uint8 int vertex_indices\n")
        f.write(b"end_header\n")
        pad = np.zeros((len(v), 5), np.float32)
        np.concatenate([v, pad], axis=1).astype("<f4").tofile(f)
        for tri in idx:
            f.write(struct.pack("<B3i", 3, *tri))
