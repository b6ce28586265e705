"""Triangle meshes: PLY loading and writing, and seeded procedural meshes.

Replaces the reference's tinyply-based Mesh (src/core/mesh.{h,cpp}):
reads vertex positions, optional per-vertex normals and texcoords, and
triangle indices (uint32/uint16/int32 lists handled like
mesh.cpp:129-146).  Supports ascii and binary_little_endian PLY.
`icosphere` builds the mesh workloads without any asset file.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray                 # (V,3) f32
    indices: np.ndarray                  # (F*3,) u32
    normals: Optional[np.ndarray] = None    # (V,3) f32
    texcoords: Optional[np.ndarray] = None  # (V,2) f32

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def compute_vertex_normals(self) -> None:
        """Area-weighted vertex normals for meshes without them."""
        v = self.vertices.astype(np.float64)
        idx = self.indices.reshape(-1, 3)
        fn = np.cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, idx[:, k], fn)
        lens = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = (n / np.maximum(lens, 1e-30)).astype(np.float32)


def subdivide(mesh: Mesh, levels: int = 1) -> Mesh:
    """Midpoint 1->4 triangle subdivision (no smoothing): each edge gains
    a deduplicated midpoint vertex; normals are angle-preserving
    renormalized interpolations, texcoords linear.  icosphere() builds
    its meshes of 20k to 1.3M triangles with it."""
    v = mesh.vertices.astype(np.float64)
    n = (mesh.normals.astype(np.float64)
         if mesh.normals is not None else None)
    t = (mesh.texcoords.astype(np.float64)
         if mesh.texcoords is not None else None)
    idx = mesh.indices.reshape(-1, 3).astype(np.int64)
    for _ in range(levels):
        nv = len(v)
        # unique undirected edges -> midpoint vertex ids
        e = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]],
                            idx[:, [2, 0]]])
        e_key = np.sort(e, axis=1)
        uniq, inv = np.unique(e_key, axis=0, return_inverse=True)
        mid = nv + inv.reshape(3, -1)       # (3, F): m01, m12, m20
        v = np.concatenate([v, (v[uniq[:, 0]] + v[uniq[:, 1]]) * 0.5])
        if n is not None:
            # plain average (no renormalization): source PLYs may carry
            # non-unit normals (icosahedron.ply does) and the shading
            # path normalizes the interpolated normal anyway — keeping
            # the blend linear stays consistent with the originals
            n = np.concatenate([n, (n[uniq[:, 0]] + n[uniq[:, 1]]) * 0.5])
        if t is not None:
            t = np.concatenate([t, (t[uniq[:, 0]] + t[uniq[:, 1]]) * 0.5])
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        m01, m12, m20 = mid[0], mid[1], mid[2]
        idx = np.concatenate([
            np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)])
    return Mesh(vertices=v.astype(np.float32),
                indices=idx.reshape(-1).astype(np.uint32),
                normals=None if n is None else n.astype(np.float32),
                texcoords=None if t is None else t.astype(np.float32))


_PHI = (1.0 + 5.0 ** 0.5) / 2.0
#: the regular icosahedron: 12 vertices, 20 faces (counter-clockwise
#: seen from outside)
ICOSAHEDRON_VERTICES = np.array(
    [[-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
     [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
     [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]],
    np.float64)
ICOSAHEDRON_FACES = np.array(
    [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
     [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
     [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
     [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.uint32)


def icosphere(level: int, seed: int = 0, relief: float = 0.08) -> Mesh:
    """Seeded procedural mesh of 20 * 4**level triangles (level 5: 20,480;
    level 7: 327,680; level 8: 1,310,720): the icosahedron subdivided
    `level` times, projected onto the unit sphere and displaced along
    the radius by a sum of seeded random waves, so the surface has
    scan-like detail at every scale.  Vertex normals are recomputed from
    the displaced faces."""
    mesh = subdivide(Mesh(vertices=ICOSAHEDRON_VERTICES.astype(np.float32),
                          indices=ICOSAHEDRON_FACES.reshape(-1)), level)
    v = mesh.vertices.astype(np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    h = np.zeros(len(v))
    for octave in range(6):
        freq = 2.0 * 2.0 ** octave
        for _ in range(4):
            k = rng.normal(size=3)
            k *= freq / np.linalg.norm(k)
            h += np.sin(v @ k + rng.uniform(0.0, 2.0 * np.pi)) \
                / 2.0 ** octave
    v *= (1.0 + relief * h / 4.0)[:, None]
    out = Mesh(vertices=v.astype(np.float32), indices=mesh.indices)
    out.compute_vertex_normals()
    return out


def save_ply(path: str, mesh: Mesh, binary: bool = True) -> None:
    """Write a triangle mesh as PLY (binary_little_endian or ascii):
    float positions, normals when present, uchar/uint face lists."""
    idx = np.asarray(mesh.indices, np.uint32).reshape(-1, 3)
    cols = [np.asarray(mesh.vertices, np.float32)]
    names = ["x", "y", "z"]
    if mesh.normals is not None:
        cols.append(np.asarray(mesh.normals, np.float32))
        names += ["nx", "ny", "nz"]
    vtx = np.concatenate(cols, axis=1)
    header = "\n".join(
        ["ply", "format " + ("binary_little_endian" if binary else "ascii")
         + " 1.0", f"element vertex {len(vtx)}"]
        + [f"property float {n}" for n in names]
        + [f"element face {len(idx)}",
           "property list uchar uint vertex_indices", "end_header"]) + "\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(vtx.astype("<f4").tobytes())
            face = np.zeros(len(idx), [("n", "u1"), ("i", "<u4", 3)])
            face["n"] = 3
            face["i"] = idx
            f.write(face.tobytes())
        else:
            for row in vtx:
                f.write((" ".join(repr(float(x)) for x in row) + "\n")
                        .encode("ascii"))
            for tri in idx:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))


def load_ply(path: str, prefer_native: bool = True) -> Mesh:
    """Load a PLY mesh; uses the native C++ parser when built (3-5x faster,
    native/src/ply.cpp), falling back to the pure-Python reader below."""
    if prefer_native:
        try:
            from parallelraytracing_tpu import native
            if native.available():
                v, n, uv, idx = native.load_ply(path)
                mesh = Mesh(vertices=v, indices=idx, normals=n, texcoords=uv)
                if mesh.normals is None and mesh.num_triangles:
                    mesh.compute_vertex_normals()
                return mesh
        except Exception:
            pass  # fall back to the Python reader
    return _load_ply_python(path)


def _load_ply_python(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()

    # ---- header
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = None
    elements: List[Tuple[str, int, List]] = []  # (name, count, props)
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    parsed: Dict[str, Dict[str, np.ndarray]] = {}

    if fmt == "ascii":
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            cols: Dict[str, List] = {p[-1] if p[0] == "scalar" else p[3]: []
                                     for p in props}
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        cols[p[2]].append(float(text[pos])); pos += 1
                    else:
                        n = int(text[pos]); pos += 1
                        cols[p[3]].append([float(text[pos + i]) for i in range(n)])
                        pos += n
            parsed[name] = {k: np.asarray(v) for k, v in cols.items()}
    else:
        pos = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                # Fast path: fixed-stride vectorized decode.
                dtypes = [(p[2], "<" + _PLY_TYPES[p[1]][0]) for p in props]
                arr = np.frombuffer(body, dtype=np.dtype(dtypes), count=count,
                                    offset=pos)
                pos += arr.dtype.itemsize * count
                parsed[name] = {p[2]: arr[p[2]] for p in props}
            elif (len(props) == 1 and props[0][0] == "list"):
                # Common case: one list property (faces). Peek the first
                # count; if every row has the same arity, vectorize.
                _, cnt_t, val_t, pname = props[0]
                cdt, csz = _PLY_TYPES[cnt_t]
                vdt, vsz = _PLY_TYPES[val_t]
                first_n = int(np.frombuffer(body, "<" + cdt, 1, pos)[0])
                row = csz + first_n * vsz
                blob = np.frombuffer(body, np.uint8, count * row, pos)
                counts = blob.reshape(count, row)[:, :csz].copy().view("<" + cdt).ravel()
                if np.all(counts == first_n):
                    vals = (blob.reshape(count, row)[:, csz:].copy()
                            .view("<" + vdt).reshape(count, first_n))
                    parsed[name] = {pname: vals}
                    pos += count * row
                else:  # ragged: slow path
                    rows = []
                    for _ in range(count):
                        n = int(np.frombuffer(body, "<" + cdt, 1, pos)[0])
                        pos += csz
                        rows.append(np.frombuffer(body, "<" + vdt, n, pos))
                        pos += n * vsz
                    parsed[name] = {pname: rows}
            else:
                # Mixed scalar+list element: per-row decode.
                cols = {}
                for p in props:
                    cols[p[-1]] = []
                for _ in range(count):
                    for p in props:
                        if p[0] == "scalar":
                            dt, sz = _PLY_TYPES[p[1]]
                            cols[p[2]].append(np.frombuffer(body, "<" + dt, 1, pos)[0])
                            pos += sz
                        else:
                            _, cnt_t, val_t, pname = p
                            cdt, csz = _PLY_TYPES[cnt_t]
                            vdt, vsz = _PLY_TYPES[val_t]
                            n = int(np.frombuffer(body, "<" + cdt, 1, pos)[0])
                            pos += csz
                            cols[pname].append(np.frombuffer(body, "<" + vdt, n, pos))
                            pos += n * vsz
                parsed[name] = {k: np.asarray(v) for k, v in cols.items()}

    vtx = parsed.get("vertex")
    if vtx is None or "x" not in vtx:
        raise ValueError(f"{path}: no vertex element")
    vertices = np.stack([vtx["x"], vtx["y"], vtx["z"]], axis=1).astype(np.float32)

    normals = None
    if all(k in vtx for k in ("nx", "ny", "nz")):
        normals = np.stack([vtx["nx"], vtx["ny"], vtx["nz"]], axis=1).astype(np.float32)

    texcoords = None
    for ku, kv in (("u", "v"), ("s", "t")):
        if ku in vtx and kv in vtx:
            texcoords = np.stack([vtx[ku], vtx[kv]], axis=1).astype(np.float32)
            break

    face = parsed.get("face", {})
    idx_raw = face.get("vertex_indices", face.get("vertex_index"))
    if idx_raw is None:
        indices = np.zeros((0,), np.uint32)
    else:
        idx = np.asarray(idx_raw)
        if idx.ndim == 2 and idx.shape[1] == 3:
            indices = idx.astype(np.uint32).ravel()
        else:  # fan-triangulate polygons
            tris = []
            for poly in idx_raw:
                poly = np.asarray(poly, dtype=np.uint32)
                for i in range(1, len(poly) - 1):
                    tris.extend([poly[0], poly[i], poly[i + 1]])
            indices = np.asarray(tris, dtype=np.uint32)

    mesh = Mesh(vertices=vertices, indices=indices, normals=normals,
                texcoords=texcoords)
    if mesh.normals is None and mesh.num_triangles:
        mesh.compute_vertex_normals()
    return mesh
