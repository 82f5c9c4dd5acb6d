"""Binary PLY I/O for Gaussian point clouds — no third-party deps.

On-disk schema is byte-compatible with the reference checkpoints
(``SLAM/gaussian_pointcloud.py:407-466``): float32 properties
``x,y,z, nx,ny,nz, f_dc_0..2, f_rest_*, opacity, scale_0..2, rot_0..3``
with an optional trailing ``confidence``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _gaussian_property_names(n_rest: int, include_confidence: bool) -> List[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    if include_confidence:
        names.append("confidence")
    return names


def write_ply(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write a little-endian binary PLY with float32 vertex properties.

    ``columns`` maps property name -> [N] array; insertion order is the
    property order.
    """
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    data = np.stack([np.asarray(columns[k], dtype="<f4") for k in names], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
    confidence: Optional[np.ndarray] = None,
) -> None:
    """Save gaussians in the reference PLY schema.

    features_dc: [N, 3]; features_rest: [N, R, 3] (coefficient-major) — the
    flat layout written is channel-major per coefficient to match the 3DGS
    f_rest ordering (transpose(1,2).flatten, reference
    ``gaussian_pointcloud.py:436-443``).
    """
    n = xyz.shape[0]
    rest_flat = np.transpose(np.asarray(features_rest), (0, 2, 1)).reshape(n, -1)
    cols: Dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        cols[k] = xyz[:, i]
    for k in ("nx", "ny", "nz"):
        cols[k] = np.zeros(n, dtype=np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = np.asarray(features_dc)[:, i]
    for i in range(rest_flat.shape[1]):
        cols[f"f_rest_{i}"] = rest_flat[:, i]
    cols["opacity"] = np.asarray(opacity).reshape(n)
    for i in range(3):
        cols[f"scale_{i}"] = np.asarray(scaling)[:, i]
    for i in range(4):
        cols[f"rot_{i}"] = np.asarray(rotation)[:, i]
    if confidence is not None:
        cols["confidence"] = np.asarray(confidence).reshape(n)
    write_ply(path, cols)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY with float vertex properties into name -> [N] arrays.

    Supports binary little endian and ascii, which covers reference-produced
    checkpoints.
    """
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.index(b"end_header")
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    body = raw[raw.index(b"\n", header_end) + 1:]

    fmt = "binary_little_endian"
    names: List[str] = []
    types: List[str] = []
    count = 0
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            count = int(parts[2])
        elif parts[0] == "property" and parts[1] != "list":
            types.append(parts[1])
            names.append(parts[2])

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "ushort": "<u2", "short": "<i2"}
    if fmt == "ascii":
        table = np.loadtxt(
            [l for l in body.decode("ascii").splitlines() if l.strip()],
            dtype=np.float64,
        ).reshape(count, len(names))
        return {name: table[:, i].astype(np.float32) for i, name in enumerate(names)}
    dtype = np.dtype([(name, type_map[t]) for name, t in zip(names, types)])
    table = np.frombuffer(body, dtype=dtype, count=count)
    return {name: np.ascontiguousarray(table[name]) for name in names}


def read_mesh(path: str):
    """Read a triangle mesh PLY: (vertices [N, 3] f32, faces [M, 3] i32 or
    ``None`` when the file has no face element).

    Covers the GT-mesh inputs of the reference's ``eval_pcd``
    (``SLAM/eval.py:184-186`` loads them with trimesh): binary little endian
    or ascii, vertex element first, faces as ``property list uchar int``
    triangles.
    """
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.index(b"end_header")
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    body = raw[raw.index(b"\n", header_end) + 1:]

    fmt = "binary_little_endian"
    v_names: List[str] = []
    v_types: List[str] = []
    n_vertex = 0
    n_face = 0
    list_types = ("u1", "<i4")
    in_face = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_face = parts[1] == "face"
            if parts[1] == "vertex":
                n_vertex = int(parts[2])
            elif parts[1] == "face":
                n_face = int(parts[2])
        elif parts[0] == "property":
            if parts[1] == "list" and in_face:
                tm = {"uchar": "u1", "uint8": "u1", "uint": "<u4",
                      "int": "<i4", "int32": "<i4", "ushort": "<u2"}
                list_types = (tm[parts[2]], tm[parts[3]])
            elif parts[1] != "list" and not in_face:
                v_types.append(parts[1])
                v_names.append(parts[2])

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "ushort": "<u2", "short": "<i2"}
    if fmt == "ascii":
        lines = [l for l in body.decode("ascii").splitlines() if l.strip()]
        vt = np.loadtxt(lines[:n_vertex], dtype=np.float64, ndmin=2)
        xi = [v_names.index(a) for a in ("x", "y", "z")]
        verts = vt[:, xi].astype(np.float32)
        faces = None
        if n_face:
            ft = np.loadtxt(lines[n_vertex:n_vertex + n_face],
                            dtype=np.int64, ndmin=2)
            assert np.all(ft[:, 0] == 3), "only triangle meshes supported"
            faces = ft[:, 1:4].astype(np.int32)
        return verts, faces

    v_dtype = np.dtype([(n, type_map[t]) for n, t in zip(v_names, v_types)])
    vt = np.frombuffer(body, dtype=v_dtype, count=n_vertex)
    verts = np.stack([vt["x"], vt["y"], vt["z"]], axis=1).astype(np.float32)
    faces = None
    if n_face:
        f_dtype = np.dtype([("n", list_types[0]), ("v", list_types[1], (3,))])
        ft = np.frombuffer(body, dtype=f_dtype,
                           count=n_face, offset=n_vertex * v_dtype.itemsize)
        assert np.all(ft["n"] == 3), "only triangle meshes supported"
        faces = np.ascontiguousarray(ft["v"]).astype(np.int32)
    return verts, faces


def write_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary triangle-mesh PLY (test fixtures / synthetic GT)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(v)}",
        "property float x", "property float y", "property float z",
        f"element face {len(f)}",
        "property list uchar int vertex_indices",
        "end_header", ""])
    f_rec = np.empty(len(f), dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    f_rec["n"] = 3
    f_rec["v"] = f
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(v.tobytes())
        fh.write(f_rec.tobytes())


def read_gaussian_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a reference-schema gaussian PLY into structured arrays.

    Returns dict with xyz [N,3], features_dc [N,3], features_rest [N,R,3],
    opacity [N,1], scaling [N,3], rotation [N,4], confidence [N,1].
    """
    cols = read_ply(path)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)
    rest_names = sorted(
        (k for k in cols if k.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    if rest_names:
        rest = np.stack([cols[k] for k in rest_names], axis=1)
        rest = rest.reshape(n, 3, -1).transpose(0, 2, 1)  # -> [N, R, 3]
    else:
        rest = np.zeros((n, 0, 3), dtype=np.float32)
    scaling = np.stack([cols[f"scale_{i}"] for i in range(3)], axis=1)
    rotation = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)
    opacity = cols["opacity"].reshape(n, 1)
    confidence = cols.get("confidence", np.zeros(n, np.float32)).reshape(n, 1)
    return {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": rest,
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
        "confidence": confidence,
    }


def merge_gaussian_ply(path0: str, path1: str, out_path: str) -> None:
    """Concatenate two gaussian PLYs (reference ``SLAM/utils.py:383-392``)."""
    a, b = read_ply(path0), read_ply(path1)
    merged = {k: np.concatenate([a[k], b[k]]) for k in a if k in b}
    write_ply(out_path, merged)
