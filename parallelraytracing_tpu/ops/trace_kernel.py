"""The GPU path-trace kernel (Pallas, Triton backend).

One kernel traces a block of rays through a number of bounces.  Each lane
of a Triton program is one path: it walks its own ray through stackless
threaded BVHs (preorder with miss links, one per primitive kind), gathers
node and primitive rows from device memory (L1/L2 hold the hot ones), and
keeps the whole path state in registers between bounces.  This is the
one-thread-per-pixel megakernel shape of the reference's CUDA renderer
(cuda_megakernel/renderer.cu:132-173).

The same kernel serves two callers:

- `trace_paths`: camera rays in, radiance out, every bounce in one launch
  (the fused engine, sharded, adaptive);
- `trace_segment`: carried ray state in and out, `n_bounces` per launch
  over a compacted queue (the wavefront_fused engine and the bench's ray
  counter).

RNG is a stateless PCG hash of (pixel id, depth, draw, frame seed)
(optix/device_types.h:109-120), so ray order, block size, sharding and the
segment schedule cannot change a pixel's streams: the engines built on
this kernel agree bit for bit.  Geometry and material semantics follow
ops/intersect.py and ops/materials.py, which stay the correctness oracle;
image agreement with it is statistical (different RNG streams).

Table layout: one primitive or node per row, so a lane's fetch of a row
touches one or two 32-byte sectors.

    sph   (Ns, 8):  cx cy cz r2 ord mid 0 0
    quad  (Nq, 16): n(3) cn us(3) cu vs(3) cv ord mid 0 0
    tri   (Nt, 16): v0(3) e1(3) e2(3) ord mid 0 ...
    tattr (Nt, 16|32): n0(3) n1(3) n2(3) [uv0(2) uv1(2) uv2(2)]
    nodes (M, 8):   bbox min(3) max(3), miss link (int32 bits),
                    leaf (int32 bits: lo << LEAF_BITS | count, -1 inner)
    mats  (Nm, 8):  type c(3) extra 0 0 0 — c is emission for emissive
                    materials and albedo otherwise; extra is roughness
                    (metal), IoR (dielectric) or 1
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from parallelraytracing_tpu.core.scene import (
    KIND_SPHERE, MAT_DIELECTRIC, MAT_EMISSIVE, MAT_LAMBERTIAN, MAT_METAL)

#: rays per Triton program (one lane per ray) and warps per program:
#: one warp of 32 rays.  A block runs until its longest path ends, so
#: small blocks idle fewer lanes; on an H100 the trace step takes 1.91
#: ms (headline) at 32/1 against 3.26 at 64/2 and 4.14 at 128/4 (PERF.md)
BLOCK = 32
NUM_WARPS = 1
#: most primitives in one BVH leaf (2 and 8 measured within 4% and 17%)
LEAF = 4
LEAF_BITS = 4
TWO_PI = 2.0 * math.pi
BIG = 3.0e38


# ---------------------------------------------------------------------------
# RNG: stateless PCG on per-lane counters.
# ---------------------------------------------------------------------------

def _pcg_hash(x: jax.Array) -> jax.Array:
    """PCG output permutation (optix/device_types.h:109-114)."""
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> 28) + jnp.uint32(4))) ^ state) \
        * jnp.uint32(277803737)
    return (word >> 22) ^ word


def _uniform01(counter: jax.Array, salt: int) -> jax.Array:
    """[0,1) uniforms from a stateless hash of per-lane counters."""
    bits = _pcg_hash(counter ^ jnp.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF))
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) \
        * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# BVH build (host): full-sweep SAH, emitted as a threaded preorder table.
# ---------------------------------------------------------------------------

def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def build_bvh(mn: np.ndarray, mx: np.ndarray, leaf: Optional[int] = None):
    """SAH BVH over primitive boxes -> (perm, nodes (M, 8) f32).

    perm lists the primitive ids in leaf order; a leaf covers the
    contiguous run perm[lo:lo + count].  Splits minimise the surface-area
    heuristic over every centroid-sorted position on each axis; nodes
    deeper than 64 fall back to median splits so degenerate inputs stay
    bounded.  Records are created in preorder, so a record's id is its
    table row and the miss link of a left child is its right sibling."""
    n = len(mn)
    assert n >= 1
    leaf = LEAF if leaf is None else leaf
    mn = np.asarray(mn, np.float64)
    mx = np.asarray(mx, np.float64)
    cen = (mn + mx) * 0.5
    lo_b, hi_b, left, right, leaf_lo, leaf_n = [], [], [], [], [], []
    perm = []
    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def split(ids, depth):
        if depth > 64:
            ax = int(np.argmax(cen[ids].max(0) - cen[ids].min(0)))
            order = ids[np.argsort(cen[ids, ax], kind="stable")]
            h = len(ids) // 2
            return order[:h], order[h:]
        best = None
        k = np.arange(1, len(ids))
        for ax in range(3):
            order = ids[np.argsort(cen[ids, ax], kind="stable")]
            a, b = mn[order], mx[order]
            la = _area(np.minimum.accumulate(a, 0),
                       np.maximum.accumulate(b, 0))[:-1]
            ra = _area(np.minimum.accumulate(a[::-1], 0)[::-1],
                       np.maximum.accumulate(b[::-1], 0)[::-1])[1:]
            cost = la * k + ra * (len(ids) - k)
            i = int(np.argmin(cost))
            if best is None or cost[i] < best[0]:
                best = (cost[i], order, i + 1)
        _, order, s = best
        return order[:s], order[s:]

    def build(ids, depth):
        me = len(lo_b)
        lo_b.append(mn[ids].min(0))
        hi_b.append(mx[ids].max(0))
        left.append(-1)
        right.append(-1)
        leaf_lo.append(len(perm))
        leaf_n.append(0)
        if len(ids) <= leaf:
            perm.extend(ids.tolist())
            leaf_n[me] = len(ids)
            return me
        a, b = split(ids, depth)
        left[me] = build(a, depth + 1)
        right[me] = build(b, depth + 1)
        return me

    build(np.arange(n), 0)
    m = len(lo_b)
    miss = np.full(m, -1, np.int32)
    for r in range(m):
        if left[r] >= 0:
            miss[left[r]] = right[r]
            miss[right[r]] = miss[r]
    is_leaf = np.asarray(left) < 0
    enc = np.where(is_leaf,
                   (np.asarray(leaf_lo, np.int64) << LEAF_BITS)
                   | np.asarray(leaf_n, np.int64), -1)
    assert enc.max() < 2 ** 31, "too many primitives for the leaf encoding"
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = np.asarray(lo_b)
    nodes[:, 3:6] = np.asarray(hi_b)
    nodes[:, 6] = miss.view(np.float32)
    nodes[:, 7] = enc.astype(np.int32).view(np.float32)
    return np.asarray(perm, np.int64), nodes


def node_links(nodes: np.ndarray):
    """(miss, leaf) int32 columns of a node table (host-side decode)."""
    return (np.ascontiguousarray(nodes[:, 6]).view(np.int32),
            np.ascontiguousarray(nodes[:, 7]).view(np.int32))


# ---------------------------------------------------------------------------
# Scene tables (host packing).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Device tables of one scene for the kernel (module doc for the
    layouts).  Absent kinds are None and compile away; the static fields
    below ride as pytree metadata."""

    mats: jax.Array
    sph: Optional[jax.Array] = None
    sph_nodes: Optional[jax.Array] = None
    quad: Optional[jax.Array] = None
    quad_nodes: Optional[jax.Array] = None
    tri: Optional[jax.Array] = None
    tri_attr: Optional[jax.Array] = None
    tri_nodes: Optional[jax.Array] = None
    #: (Nl, 32) samplable lights; None unless NEE is on and lights exist
    lights: Optional[jax.Array] = None
    #: instancing: local triangles, their attributes, the concatenated
    #: per-mesh BVHs, instance world boxes (Ni, 8) and records (Ni, 32)
    itri: Optional[jax.Array] = None
    itri_attr: Optional[jax.Array] = None
    blas_nodes: Optional[jax.Array] = None
    ibox: Optional[jax.Array] = None
    inst: Optional[jax.Array] = None
    #: (T, 4) f32 texels of every image texture, row-major per texture
    tex: Optional[jax.Array] = None

    #: constant (3-tuple) or gradient + sun (13-tuple) sky (_sky_spec)
    sky: Tuple = (0.0, 0.0, 0.0)
    #: ((mat id, cell scale, odd r, g, b), ...) checker materials
    checker: Tuple = ()
    #: ((mat id, texel offset, height, width), ...) image textures
    itex: Tuple = ()
    #: scene box (lo, 1/extent) for the wavefront origin sort
    bb: Tuple = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

    def inputs(self):
        """(names, arrays) of the present tables, in kernel order."""
        names = [f.name for f in dataclasses.fields(self)
                 if f.name in _TABLE_FIELDS
                 and getattr(self, f.name) is not None]
        return tuple(names), [getattr(self, k) for k in names]


_TABLE_FIELDS = ("mats", "sph", "sph_nodes", "quad", "quad_nodes", "tri",
                 "tri_attr", "tri_nodes", "lights", "itri", "itri_attr",
                 "blas_nodes", "ibox", "inst", "tex")

jax.tree_util.register_dataclass(
    SceneTables, data_fields=list(_TABLE_FIELDS),
    meta_fields=["sky", "checker", "itex", "bb"])


def sky_spec(host_scene) -> Tuple:
    """The kernel's static sky: the reference's constant sky as a
    3-tuple, or (bottom3, top3, sun_dir3, sun_color3, power) for scenes
    using Scene.set_sky — the same values ops/sky.sky_radiance reads."""
    bot = tuple(float(x) for x in np.asarray(host_scene.sky))
    top = host_scene.sky_top
    sun = host_scene.sun
    if top is None and sun is None:
        return bot
    top = bot if top is None else tuple(float(x) for x in np.asarray(top))
    if sun is None:
        sd, sc, p = (0.0, 1.0, 0.0), (0.0, 0.0, 0.0), 1
    else:
        sun = np.asarray(sun)
        sd = tuple(float(x) for x in sun[0:3])
        sc = tuple(float(x) for x in sun[3:6])
        p = int(sun[6])
    return bot + top + sd + sc + (p,)


def _rows(width: int, *cols) -> np.ndarray:
    """Stack (N,) / (N, k) columns into an (N, width) f32 row table."""
    parts = [np.asarray(c, np.float32).reshape(len(c), -1) for c in cols]
    out = np.concatenate(parts, axis=1)
    assert out.shape[1] <= width, (out.shape, width)
    return np.pad(out, ((0, 0), (0, width - out.shape[1])))


def _kind_tables(mn, mx, valid, rows: np.ndarray):
    """BVH over the valid primitives of one kind -> (rows in leaf order,
    nodes), or (None, None) when the kind has no valid primitive."""
    ids = np.nonzero(valid)[0]
    if len(ids) == 0:
        return None, None
    perm, nodes = build_bvh(mn[ids], mx[ids])
    return rows[ids[perm]], nodes


def pack_lights(scene) -> Optional[np.ndarray]:
    """(Nl, 32) light rows for in-kernel NEE: [kind, ord, center(3), r,
    u(3), v(3), normal(3), emit(3), cn, us(3), cu, vs(3), cv, r2] per
    samplable emissive primitive (ops/nee.extract_lights order).  The
    last ten are the light's own packed test constants, so the shadow
    walk can compute the light's hit distance exactly as the primitive
    test does."""
    from parallelraytracing_tpu.ops.nee import extract_lights
    lt = extract_lights(scene)
    if lt is None:
        return None
    kind = np.asarray(lt.kind)
    idx = np.asarray(lt.idx)
    n_sph_full = int(np.asarray(scene.sph_valid).shape[0])
    ordv = np.where(kind == KIND_SPHERE, idx, n_sph_full + idx)
    lc = np.asarray(lt.center, np.float32)
    lr = np.asarray(lt.radius, np.float32)
    lu = np.asarray(lt.u, np.float32)
    lv = np.asarray(lt.v, np.float32)
    ln = np.asarray(lt.normal, np.float32)
    us = lu / np.maximum((lu * lu).sum(1, keepdims=True), 1e-30)
    vs = lv / np.maximum((lv * lv).sum(1, keepdims=True), 1e-30)
    return _rows(32, kind, ordv, lc, lr, lu, lv, ln,
                 np.asarray(lt.emit, np.float32), (lc * ln).sum(1), us,
                 (lc * us).sum(1), vs, (lc * vs).sum(1), lr * lr)


def _tri_rows(v0, v1, v2, ordv, mid):
    return _rows(16, v0, v1 - v0, v2 - v0, ordv, mid)


def pack_instances(inst_meshes, instances, ord_base: int, with_uv: bool):
    """Instancing tables: (itri, itri_attr, blas_nodes, ibox, inst).

    Unique meshes are stored once in local space, each with its own BVH;
    the BVHs are concatenated with global row indices.  inst rows hold
    [BLAS root, world->local affine (3x4 row-major), local->world normal
    matrix (3x3 = inverse transpose), material id, ordinal base]."""
    from parallelraytracing_tpu.accel.tlas import _mesh_local_arrays
    tri_t, attr_t, node_t = [], [], []
    roots, boxes, counts = [], [], []
    node_off = tri_off = 0
    for mesh in inst_meshes:
        v0, v1, v2, n0, n1, n2 = (np.asarray(a, np.float64)
                                  for a in _mesh_local_arrays(mesh))
        nt = len(v0)
        mn = np.minimum(np.minimum(v0, v1), v2)
        mx = np.maximum(np.maximum(v0, v1), v2)
        perm, nodes = build_bvh(mn, mx)
        cols = [n0, n1, n2]
        if with_uv:
            tc = getattr(mesh, "texcoords", None)
            idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
            if tc is not None and len(tc):
                tc = np.asarray(tc, np.float64)
                cols += [tc[idx[:, k]] for k in range(3)]
            else:
                cols += [np.zeros((nt, 2))] * 3
        # local index j keeps its ordinal ord_base + j after the permute
        tri_t.append(_tri_rows(v0, v1, v2, np.arange(nt), np.zeros(nt))[perm])
        attr_t.append(_rows(32 if with_uv else 16, *cols)[perm])
        miss, enc = node_links(nodes)
        miss = np.where(miss >= 0, miss + node_off, -1).astype(np.int32)
        enc = np.where(enc >= 0, enc + (tri_off << LEAF_BITS),
                       -1).astype(np.int32)
        nodes = nodes.copy()
        nodes[:, 6] = miss.view(np.float32)
        nodes[:, 7] = enc.view(np.float32)
        node_t.append(nodes)
        roots.append(node_off)
        boxes.append((mn.min(0), mx.max(0)))
        counts.append(nt)
        node_off += len(nodes)
        tri_off += nt
    ibox = np.zeros((len(instances), 8), np.float32)
    inst = np.zeros((len(instances), 32), np.float32)
    for k, (mi, mid, m4) in enumerate(instances):
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)
        lo, hi = boxes[mi]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        wc = corners @ m4[:3, :3].T + m4[:3, 3]
        ibox[k, 0:3] = wc.min(0)
        ibox[k, 3:6] = wc.max(0)
        inst[k, 0] = roots[mi]
        inst[k, 1:13] = inv[:3, :4].reshape(-1)
        inst[k, 13:22] = inv[:3, :3].T.reshape(-1)
        inst[k, 22] = mid
        inst[k, 23] = ord_base + k * tri_off
    return (np.concatenate(tri_t), np.concatenate(attr_t),
            np.concatenate(node_t), ibox, inst)


def pack_textures(scene):
    """(itex spec, (T, 4) texel rows) of every image-textured material."""
    from parallelraytracing_tpu.ops.textures import TEX_IMAGE_BASE
    mat_tex = np.asarray(scene.mat_tex)
    atlas = np.asarray(scene.tex_atlas, np.float32)
    size = np.asarray(scene.tex_size)
    chunks, offs, itex = [], {}, []
    off = 0
    for mid, tex in enumerate(mat_tex):
        if tex < TEX_IMAGE_BASE:
            continue
        tid = int(tex - TEX_IMAGE_BASE)
        th, tw = int(size[tid, 0]), int(size[tid, 1])
        if tid not in offs:
            offs[tid] = off
            chunks.append(atlas[tid, :th, :tw].reshape(-1, 3))
            off += th * tw
        itex.append((float(mid), offs[tid], th, tw))
    texels = np.concatenate(chunks)
    return tuple(itex), _rows(4, texels)


def pack_scene(scene, nee: bool) -> SceneTables:
    """Pack a Scene for the kernel.  Instanced meshes stay in local space
    (memory proportional to unique meshes, the reference's IAS-over-GAS,
    optix/renderer.cpp:833-870); flat primitives are packed per kind."""
    from parallelraytracing_tpu.accel.lbvh import scene_primitive_aabbs
    from parallelraytracing_tpu.core import geometry as geo

    has_img = any(t >= 2 for t in getattr(scene, "_mat_tex", []))
    instanced = bool(getattr(scene, "instances", None))
    host = jax.device_get(scene.build(bake_instances=False) if instanced
                          else scene.build())

    mt = np.asarray(host.mat_type, np.float32)
    emit = np.asarray(host.mat_emit, np.float32)
    alb = np.asarray(host.mat_albedo, np.float32)
    c = np.where((mt == MAT_EMISSIVE)[:, None], emit, alb)
    extra = np.where(mt == MAT_METAL, np.asarray(host.mat_rough),
                     np.where(mt == MAT_DIELECTRIC,
                              np.asarray(host.mat_ior), 1.0))
    out = {"mats": _rows(8, mt, c, extra)}

    n_sph = int(np.asarray(host.sph_valid).shape[0])
    n_quad = int(np.asarray(host.quad_valid).shape[0])
    n_tri = int(np.asarray(host.tri_valid).shape[0])

    sc = np.asarray(host.sph_center, np.float64)
    sr = np.asarray(host.sph_radius, np.float64)
    s_mn, s_mx = geo.sphere_aabb(sc, sr)
    out["sph"], out["sph_nodes"] = _kind_tables(
        s_mn, s_mx, np.asarray(host.sph_valid),
        _rows(8, sc, sr * sr, np.arange(n_sph), host.sph_mat))

    qn = np.asarray(host.quad_normal, np.float32)
    qc = np.asarray(host.quad_center, np.float32)
    qu = np.asarray(host.quad_u, np.float32)
    qv = np.asarray(host.quad_v, np.float32)
    q_mn, q_mx = geo.quad_aabb(qc.astype(np.float64), qu.astype(np.float64),
                               qv.astype(np.float64))
    us = qu / np.maximum((qu * qu).sum(1, keepdims=True), 1e-30)
    vs = qv / np.maximum((qv * qv).sum(1, keepdims=True), 1e-30)
    out["quad"], out["quad_nodes"] = _kind_tables(
        q_mn, q_mx, np.asarray(host.quad_valid),
        _rows(16, qn, (qc * qn).sum(1), us, (qc * us).sum(1), vs,
              (qc * vs).sum(1), n_sph + np.arange(n_quad), host.quad_mat))

    v0 = np.asarray(host.tri_v0, np.float32)
    v1 = np.asarray(host.tri_v1, np.float32)
    v2 = np.asarray(host.tri_v2, np.float32)
    t_mn, t_mx = geo.triangle_aabb(v0.astype(np.float64),
                                   v1.astype(np.float64),
                                   v2.astype(np.float64))
    tvalid = np.asarray(host.tri_valid)
    t_ids = np.nonzero(tvalid)[0]
    if len(t_ids):
        perm, out["tri_nodes"] = build_bvh(t_mn[t_ids], t_mx[t_ids])
        sel = t_ids[perm]
        out["tri"] = _tri_rows(v0[sel], v1[sel], v2[sel],
                               n_sph + n_quad + sel,
                               np.asarray(host.tri_mat)[sel])
        cols = [np.asarray(host.tri_n0)[sel], np.asarray(host.tri_n1)[sel],
                np.asarray(host.tri_n2)[sel]]
        if has_img and getattr(host, "tri_uv0", None) is not None:
            cols += [np.asarray(host.tri_uv0)[sel],
                     np.asarray(host.tri_uv1)[sel],
                     np.asarray(host.tri_uv2)[sel]]
        out["tri_attr"] = _rows(32 if has_img else 16, *cols)

    if nee:
        out["lights"] = pack_lights(host)

    mins, maxs = [], []
    mn, mx, _, _ = scene_primitive_aabbs(host)
    if len(mn):
        mins.append(mn)
        maxs.append(mx)
    if instanced:
        (out["itri"], out["itri_attr"], out["blas_nodes"], out["ibox"],
         out["inst"]) = pack_instances(scene._inst_meshes, scene.instances,
                                       n_sph + n_quad + n_tri, has_img)
        mins.append(out["ibox"][:, 0:3])
        maxs.append(out["ibox"][:, 3:6])

    itex = ()
    if has_img:
        itex, out["tex"] = pack_textures(host)

    if mins:
        lo = np.concatenate(mins).min(0)
        ext = np.maximum(np.concatenate(maxs).max(0) - lo, 1e-9)
    else:
        lo, ext = np.zeros(3), np.ones(3)
    checker = tuple(
        (float(i), float(p[0]), float(p[1]), float(p[2]), float(p[3]))
        for i, (tx, p) in enumerate(zip(getattr(scene, "_mat_tex", []),
                                        getattr(scene, "_mat_tex_param",
                                                [])))
        if tx == 1)
    arrays = {k: (None if v is None else jax.device_put(jnp.asarray(v)))
              for k, v in out.items()}
    return SceneTables(
        **arrays, sky=sky_spec(host), checker=checker, itex=itex,
        bb=(tuple(float(x) for x in lo),
            tuple(float(1.0 / x) for x in ext)))


# ---------------------------------------------------------------------------
# Per-lane geometry tests (shared by the walk and the NEE light seed).
# ---------------------------------------------------------------------------

def _sphere_t(o, d, cx, cy, cz, r2, t_min):
    ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
    b = d[0] * ocx + d[1] * ocy + d[2] * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = -b - sq
    t = jnp.where(t_near >= t_min, t_near, -b + sq)
    return t, (disc >= 0.0) & (t >= t_min)


def _quad_t(o, d, n, cn, us, cu, vs, cv, t_min):
    dn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    on = o[0] * n[0] + o[1] * n[1] + o[2] * n[2]
    dok = jnp.abs(dn) >= 1e-8
    t = (cn - on) * jnp.where(dok, 1.0 / jnp.where(dok, dn, 1.0), 0.0)
    a = (o[0] * us[0] + o[1] * us[1] + o[2] * us[2]) \
        + t * (d[0] * us[0] + d[1] * us[1] + d[2] * us[2]) - cu
    b = (o[0] * vs[0] + o[1] * vs[1] + o[2] * vs[2]) \
        + t * (d[0] * vs[0] + d[1] * vs[1] + d[2] * vs[2]) - cv
    return t, dok & (t > t_min) & (a * a < 1.0) & (b * b < 1.0)


def _tri_t(o, d, v0, e1, e2, t_min):
    """Moller-Trumbore (shape.h:262-303): (t, ok, b1, b2)."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    dok = det != 0.0
    inv = jnp.where(dok, 1.0 / jnp.where(dok, det, 1.0), 0.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    b1 = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    b2 = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    ok = dok & (t >= t_min) & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    return t, ok, b1, b2


def _safe_inv(x):
    eps = 1e-20
    return 1.0 / jnp.where(jnp.abs(x) < eps, jnp.where(x < 0, -eps, eps), x)


def _ld(ref, idx, *cols):
    """Per-lane gather of row idx, columns cols."""
    return tuple(ref[idx, k] for k in cols)


def _ld_i32(ref, idx, k):
    return jax.lax.bitcast_convert_type(ref[idx, k], jnp.int32)


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------

# closest-hit carry slots
_T, _ORD, _KIND, _IDX, _B1, _B2, _INST = range(7)
_K_NONE, _K_SPH, _K_QUAD, _K_TRI, _K_ITRI = range(5)


def _make_kernel(names, n_in: int, n_bounces: int, out: str,
                 t_min: float, t_max: float, rr_depth: int, sky: tuple,
                 checker: tuple, itex: tuple):
    """out: "radiance" (3 planes), "state" (the 13 ray-state planes) or
    "hit" (closest-hit t, inf on a miss, and global primitive ordinal,
    -1 on a miss, of the input rays; no bounce is traced)."""
    tmax_inf = t_max >= 1e30

    def kernel(scal_ref, pix_ref, *refs):
        planes = refs[:n_in]
        tab = dict(zip(names, refs[n_in:n_in + len(names)]))
        outs = refs[n_in + len(names):]
        seed = scal_ref[0]
        depth0 = scal_ref[1]
        count = scal_ref[2]
        slot = pl.program_id(0) * BLOCK \
            + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
        f0 = jnp.zeros((BLOCK,), jnp.float32)
        i0 = jnp.zeros((BLOCK,), jnp.int32)
        pix = pix_ref[...]
        rng_base = _pcg_hash(pix.astype(jnp.uint32)
                             ^ seed.astype(jnp.uint32))
        if n_in == 13:
            state = tuple(p[...] for p in planes)
        else:
            one = f0 + 1.0
            state = tuple(p[...] for p in planes) + (one, one, one,
                                                     f0, f0, f0, one)
        alive = jnp.where(slot < count, state[12], 0.0)
        state = state[:12] + (alive,)

        mats = tab["mats"]
        n_lights = tab["lights"].shape[0] if "lights" in tab else 0
        n_inst = tab["inst"].shape[0] if "inst" in tab else 0

        def tcap(ok, t):
            return ok if tmax_inf else ok & (t <= t_max)

        def walk(nodes, node, o, inv, carry, leaf_fn, shadow):
            """Per-lane threaded-BVH walk: each lane descends into a node
            whose box it enters at better-than-best t, else follows the
            miss link; leaves run leaf_fn over their primitive run."""
            def cond(c):
                return jnp.max(c[0]) >= 0

            def body(c):
                node, carry = c
                nd = jnp.maximum(node, 0)
                b = _ld(nodes, nd, 0, 1, 2, 3, 4, 5)
                miss = _ld_i32(nodes, nd, 6)
                enc = _ld_i32(nodes, nd, 7)
                tx0 = (b[0] - o[0]) * inv[0]
                tx1 = (b[3] - o[0]) * inv[0]
                ty0 = (b[1] - o[1]) * inv[1]
                ty1 = (b[4] - o[1]) * inv[1]
                tz0 = (b[2] - o[2]) * inv[2]
                tz1 = (b[5] - o[2]) * inv[2]
                tn = jnp.maximum(
                    jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                    jnp.maximum(jnp.minimum(tz0, tz1), t_min))
                tf = jnp.minimum(
                    jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                    jnp.minimum(jnp.maximum(tz0, tz1), carry[_T]))
                hit = (tf >= tn) & (node >= 0)
                is_leaf = enc >= 0
                lh = hit & is_leaf
                span = jnp.where(lh, enc & ((1 << LEAF_BITS) - 1), 0)
                lo = enc >> LEAF_BITS

                def leaves(carry):
                    def prim(j, carry):
                        m = j < span
                        return leaf_fn(carry, jnp.where(m, lo + j, 0), m)
                    return jax.lax.fori_loop(0, jnp.max(span), prim, carry)

                carry = jax.lax.cond(jnp.max(span) > 0, leaves,
                                     lambda c: c, carry)
                node = jnp.where(node < 0, -1,
                                 jnp.where(hit & ~is_leaf, node + 1, miss))
                if shadow:  # any-hit: a resolved lane stops walking
                    node = jnp.where(carry[_T] < 0.0, -1, node)
                return node, carry

            return jax.lax.while_loop(cond, body, (node, carry))[1]

        def better(carry, t, ok, m, ordv):
            return m & tcap(ok, t) & (
                (t < carry[_T]) | ((t == carry[_T]) & (ordv < carry[_ORD])))

        def fold(carry, upd, t, ordv, kind, idx, b1=None, b2=None,
                 inst=None):
            sel = lambda a, b: jnp.where(upd, a, b)
            return (sel(t, carry[_T]), sel(ordv, carry[_ORD]),
                    sel(jnp.int32(kind), carry[_KIND]), sel(idx, carry[_IDX]),
                    carry[_B1] if b1 is None else sel(b1, carry[_B1]),
                    carry[_B2] if b2 is None else sel(b2, carry[_B2]),
                    carry[_INST] if inst is None else sel(inst,
                                                          carry[_INST]))

        def shadow_fold(carry, upd, lord, ordv):
            # any occluder other than the light resolves the lane
            upd = upd & (ordv != lord)
            return (jnp.where(upd, -BIG, carry[0]), carry[1])

        def scene_hit(o, d, active, shadow=None):
            """Closest hit of one ray per lane (or, with shadow =
            (t_light, light ordinal), the any-hit occlusion test)."""
            inv = (_safe_inv(d[0]), _safe_inv(d[1]), _safe_inv(d[2]))
            if shadow is None:
                carry = (jnp.where(active, BIG, -BIG), f0 + float(1 << 30),
                         i0, i0, f0, f0, i0)
            else:
                carry = (jnp.where(active, shadow[0], -BIG), shadow[1])
            root = jnp.where(active, 0, -1)

            def fin(carry, upd, t, ordv, kind, idx, **kw):
                if shadow is None:
                    return fold(carry, upd, t, ordv, kind, idx, **kw)
                return shadow_fold(carry, upd, shadow[1], ordv)

            if "sph" in tab:
                sph = tab["sph"]

                def sph_leaf(carry, j, m):
                    cx, cy, cz, r2, ordv = _ld(sph, j, 0, 1, 2, 3, 4)
                    t, ok = _sphere_t(o, d, cx, cy, cz, r2, t_min)
                    return fin(carry, better(carry, t, ok, m, ordv), t, ordv,
                               _K_SPH, j)
                carry = walk(tab["sph_nodes"], root, o, inv, carry,
                             sph_leaf, shadow is not None)

            if "quad" in tab:
                quad = tab["quad"]

                def quad_leaf(carry, j, m):
                    q = _ld(quad, j, *range(14))
                    t, ok = _quad_t(o, d, q[0:3], q[3], q[4:7], q[7],
                                    q[8:11], q[11], t_min)
                    return fin(carry, better(carry, t, ok, m, q[12]), t,
                               q[12], _K_QUAD, j)
                carry = walk(tab["quad_nodes"], root, o, inv, carry,
                             quad_leaf, shadow is not None)

            if "tri" in tab:
                tri = tab["tri"]

                def tri_leaf(carry, j, m):
                    g = _ld(tri, j, *range(10))
                    t, ok, b1, b2 = _tri_t(o, d, g[0:3], g[3:6], g[6:9],
                                           t_min)
                    return fin(carry, better(carry, t, ok, m, g[9]), t, g[9],
                               _K_TRI, j, b1=b1, b2=b2)
                carry = walk(tab["tri_nodes"], root, o, inv, carry,
                             tri_leaf, shadow is not None)

            if n_inst:
                inst, ibox = tab["inst"], tab["ibox"]
                itri = tab["itri"]

                def one_instance(ii, carry):
                    bx = tuple(ibox[ii, k] for k in range(6))
                    tx0 = (bx[0] - o[0]) * inv[0]
                    tx1 = (bx[3] - o[0]) * inv[0]
                    ty0 = (bx[1] - o[1]) * inv[1]
                    ty1 = (bx[4] - o[1]) * inv[1]
                    tz0 = (bx[2] - o[2]) * inv[2]
                    tz1 = (bx[5] - o[2]) * inv[2]
                    tn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                                 jnp.minimum(ty0, ty1)),
                                     jnp.maximum(jnp.minimum(tz0, tz1),
                                                 t_min))
                    tf = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                                 jnp.maximum(ty0, ty1)),
                                     jnp.minimum(jnp.maximum(tz0, tz1),
                                                 carry[_T]))
                    enter = (tf >= tn) & (carry[_T] >= 0.0)

                    def visit(carry):
                        w = tuple(inst[ii, k] for k in range(1, 13))
                        lo_ = tuple(w[4 * r] * o[0] + w[4 * r + 1] * o[1]
                                    + w[4 * r + 2] * o[2] + w[4 * r + 3]
                                    for r in range(3))
                        ld = tuple(w[4 * r] * d[0] + w[4 * r + 1] * d[1]
                                   + w[4 * r + 2] * d[2] for r in range(3))
                        linv = (_safe_inv(ld[0]), _safe_inv(ld[1]),
                                _safe_inv(ld[2]))
                        ob = inst[ii, 23]
                        iid = i0 + ii

                        def itri_leaf(carry, j, m):
                            g = _ld(itri, j, *range(10))
                            t, ok, b1, b2 = _tri_t(lo_, ld, g[0:3], g[3:6],
                                                   g[6:9], t_min)
                            ordv = ob + g[9]
                            return fin(carry, better(carry, t, ok, m, ordv),
                                       t, ordv, _K_ITRI, j, b1=b1, b2=b2,
                                       inst=iid)
                        root_i = inst[ii, 0].astype(jnp.int32)
                        return walk(tab["blas_nodes"],
                                    jnp.where(enter, root_i, -1), lo_, linv,
                                    carry, itri_leaf, shadow is not None)

                    return jax.lax.cond(jnp.max(enter.astype(jnp.int32)) > 0,
                                        visit, lambda c: c, carry)

                carry = jax.lax.fori_loop(0, n_inst, one_instance, carry)
            return carry

        def bounce(depth, state):
            (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive) = state
            o = (ox, oy, oz)
            d = (dx, dy, dz)
            rng = rng_base + depth.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
            alive_b = alive > 0.0
            # NEE marks "emission already sampled at the previous diffuse
            # vertex" as alive == 2
            emit_w = jnp.where(alive > 1.5, 0.0, 1.0)
            h = scene_hit(o, d, alive_b)
            t = h[_T]
            kind = h[_KIND]
            hit = alive_b & (t < BIG)
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz

            # ---- resolve the winner: shading normal, front face, material
            nrx = f0
            nry = f0
            nrz = f0
            front = f0
            mid = i0
            u_c = f0
            v_c = f0
            b1, b2 = h[_B1], h[_B2]
            b0 = 1.0 - b1 - b2
            if "sph" in tab:
                m = kind == _K_SPH
                j = jnp.where(m, h[_IDX], 0)
                cx, cy, cz, mf = _ld(tab["sph"], j, 0, 1, 2, 5)
                sx, sy, sz = px - cx, py - cy, pz - cz
                nrx = jnp.where(m, sx, nrx)
                nry = jnp.where(m, sy, nry)
                nrz = jnp.where(m, sz, nrz)
                front = jnp.where(m, (sx * dx + sy * dy + sz * dz < 0.0)
                                  .astype(jnp.float32), front)
                mid = jnp.where(m, mf.astype(jnp.int32), mid)
                if itex:
                    il = jax.lax.rsqrt(jnp.maximum(
                        sx * sx + sy * sy + sz * sz, 1e-30))
                    u_c = jnp.where(m, 0.5 + jnp.arctan2(sz * il, sx * il)
                                    * (1.0 / TWO_PI), u_c)
                    v_c = jnp.where(m, 0.5 - jnp.arcsin(jnp.clip(
                        sy * il, -1.0, 1.0)) * (1.0 / math.pi), v_c)
            if "quad" in tab:
                m = kind == _K_QUAD
                j = jnp.where(m, h[_IDX], 0)
                q = _ld(tab["quad"], j, 0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11,
                        13)
                nrx = jnp.where(m, q[0], nrx)
                nry = jnp.where(m, q[1], nry)
                nrz = jnp.where(m, q[2], nrz)
                front = jnp.where(m, (q[0] * dx + q[1] * dy + q[2] * dz
                                      < 0.0).astype(jnp.float32), front)
                mid = jnp.where(m, q[11].astype(jnp.int32), mid)
                if itex:
                    a = px * q[3] + py * q[4] + pz * q[5] - q[6]
                    bq = px * q[7] + py * q[8] + pz * q[9] - q[10]
                    u_c = jnp.where(m, 0.5 + 0.5 * a, u_c)
                    v_c = jnp.where(m, 0.5 + 0.5 * bq, v_c)
            tri_kinds = []
            if "tri" in tab:
                tri_kinds.append((_K_TRI, tab["tri_attr"], None))
            if n_inst:
                tri_kinds.append((_K_ITRI, tab["itri_attr"], tab["inst"]))
            for kid, attr, inst in tri_kinds:
                m = kind == kid
                j = jnp.where(m, h[_IDX], 0)
                a = _ld(attr, j, *range(15 if itex else 9))
                nx_ = b0 * a[0] + b1 * a[3] + b2 * a[6]
                ny_ = b0 * a[1] + b1 * a[4] + b2 * a[7]
                nz_ = b0 * a[2] + b1 * a[5] + b2 * a[8]
                if inst is None:
                    mf = tab["tri"][j, 10]
                else:
                    ii = jnp.where(m, h[_INST], 0)
                    mt_ = _ld(inst, ii, *range(13, 22))
                    nx_, ny_, nz_ = (
                        mt_[3 * r] * nx_ + mt_[3 * r + 1] * ny_
                        + mt_[3 * r + 2] * nz_ for r in range(3))
                    mf = inst[ii, 22]
                nrx = jnp.where(m, nx_, nrx)
                nry = jnp.where(m, ny_, nry)
                nrz = jnp.where(m, nz_, nrz)
                front = jnp.where(m, (nx_ * dx + ny_ * dy + nz_ * dz <= 0.0)
                                  .astype(jnp.float32), front)
                mid = jnp.where(m, mf.astype(jnp.int32), mid)
                if itex:
                    u_c = jnp.where(m, b0 * a[9] + b1 * a[11] + b2 * a[13],
                                    u_c)
                    v_c = jnp.where(m, b0 * a[10] + b1 * a[12] + b2 * a[14],
                                    v_c)
            n_il = jax.lax.rsqrt(jnp.maximum(
                nrx * nrx + nry * nry + nrz * nrz, 1e-30))
            sgn = (front * 2.0 - 1.0) * n_il
            nx, ny, nz = nrx * sgn, nry * sgn, nrz * sgn
            m_type, c0, c1, c2, extra = _ld(mats, mid, 0, 1, 2, 3, 4)
            m_type = m_type.astype(jnp.int32)
            midf = mid.astype(jnp.float32)

            for cm, toff, th, tw in itex:
                # bilinear, repeat-wrapped (ops/textures.sample_atlas);
                # the sample multiplies the base albedo
                thf, twf = float(th), float(tw)
                x = (u_c - jnp.floor(u_c)) * twf - 0.5
                y = (1.0 - (v_c - jnp.floor(v_c))) * thf - 0.5
                x0, y0 = jnp.floor(x), jnp.floor(y)
                fx, fy = x - x0, y - y0
                sel = midf == cm

                def fetch(yi, xi):
                    yw = yi - thf * jnp.floor(yi * (1.0 / thf))
                    xw = xi - twf * jnp.floor(xi * (1.0 / twf))
                    k = (yw * twf + xw).astype(jnp.int32)
                    k = jnp.where(sel, jnp.clip(k, 0, th * tw - 1), 0) + toff
                    return _ld(tab["tex"], k, 0, 1, 2)

                t00, t01 = fetch(y0, x0), fetch(y0, x0 + 1.0)
                t10, t11 = fetch(y0 + 1.0, x0), fetch(y0 + 1.0, x0 + 1.0)
                smp = [(t00[k] * (1.0 - fx) + t01[k] * fx) * (1.0 - fy)
                       + (t10[k] * (1.0 - fx) + t11[k] * fx) * fy
                       for k in range(3)]
                c0 = jnp.where(sel, smp[0] * c0, c0)
                c1 = jnp.where(sel, smp[1] * c1, c1)
                c2 = jnp.where(sel, smp[2] * c2, c2)

            for cm, cs, o_r, o_g, o_b in checker:
                # world-cell parity of the hit point (ops/textures.py)
                coff = 0.3183098861
                cell = (jnp.floor(px * cs + coff) + jnp.floor(py * cs + coff)
                        + jnp.floor(pz * cs + coff))
                odd = cell - 2.0 * jnp.floor(cell * 0.5)
                sel = (midf == cm) & (odd > 0.5)
                c0 = jnp.where(sel, o_r, c0)
                c1 = jnp.where(sel, o_g, c1)
                c2 = jnp.where(sel, o_b, c2)

            # ---- miss: sky * throughput (cuda_megakernel/renderer.cu:98-101)
            mw = (alive_b & ~hit).astype(jnp.float32)
            if len(sky) == 3:
                sk0, sk1, sk2 = sky
            else:
                (s0, s1, s2, tp0, tp1, tp2,
                 sd0, sd1, sd2, sc0, sc1, sc2, spow) = sky
                inv_l = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
                tmix = 0.5 * (dy * inv_l + 1.0)
                sk0 = s0 + tmix * (tp0 - s0)
                sk1 = s1 + tmix * (tp1 - s1)
                sk2 = s2 + tmix * (tp2 - s2)
                if sc0 or sc1 or sc2:
                    base = jnp.maximum((dx * sd0 + dy * sd1 + dz * sd2)
                                       * inv_l, 0.0)
                    w, p = f0 + 1.0, int(spow)
                    while p:  # static binary exponentiation
                        if p & 1:
                            w = w * base
                        base, p = base * base, p >> 1
                    sk0, sk1, sk2 = sk0 + w * sc0, sk1 + w * sc1, sk2 + w * sc2
            rr = rr + mw * tr * sk0
            rg = rg + mw * tg * sk1
            rb = rb + mw * tb * sk2

            # ---- emission (material.h:119-132)
            lw = hit.astype(jnp.float32) * (m_type == MAT_EMISSIVE) * emit_w
            rr = rr + lw * tr * c0
            rg = rg + lw * tg * c1
            rb = rb + lw * tb * c2

            is_lam = m_type == MAT_LAMBERTIAN
            if n_lights:
                rr, rg, rb = nee(rng, hit & is_lam, px, py, pz, nx, ny, nz,
                                 tr, tg, tb, c0, c1, c2, rr, rg, rb)

            # ---- BSDFs (material.h semantics)
            u1 = _uniform01(rng, 1)
            u2 = _uniform01(rng, 2)
            u3 = _uniform01(rng, 3)
            z = 1.0 - 2.0 * u1
            rxy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
            phi = TWO_PI * u2
            ux, uy, uz = rxy * jnp.cos(phi), rxy * jnp.sin(phi), z
            is_met = m_type == MAT_METAL
            is_die = m_type == MAT_DIELECTRIC

            lx, ly, lz = nx + ux, ny + uy, nz + uz
            degen = (jnp.abs(lx) < 1e-8) & (jnp.abs(ly) < 1e-8) \
                & (jnp.abs(lz) < 1e-8)
            lx = jnp.where(degen, nx, lx)
            ly = jnp.where(degen, ny, ly)
            lz = jnp.where(degen, nz, lz)

            dn = dx * nx + dy * ny + dz * nz
            gx, gy, gz = dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, \
                dz - 2.0 * dn * nz
            ri = jnp.where(front > 0, 1.0 / extra, extra)
            cos_t = jnp.minimum(-dn, 1.0)
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            r0 = (1.0 - ri) / (1.0 + ri)
            r0 = r0 * r0
            omc = 1.0 - cos_t
            schl = r0 + (1.0 - r0) * omc * omc * omc * omc * omc
            refl = (ri * sin_t > 1.0) | (schl > u3)
            qx, qy, qz = ri * (dx + cos_t * nx), ri * (dy + cos_t * ny), \
                ri * (dz + cos_t * nz)
            qpar = -jnp.sqrt(jnp.abs(1.0 - (qx * qx + qy * qy + qz * qz)))
            ex = jnp.where(refl, gx, qx + qpar * nx)
            ey = jnp.where(refl, gy, qy + qpar * ny)
            ez = jnp.where(refl, gz, qz + qpar * nz)
            sx = jnp.where(is_lam, lx, jnp.where(is_met, gx + extra * ux, ex))
            sy = jnp.where(is_lam, ly, jnp.where(is_met, gy + extra * uy, ey))
            sz = jnp.where(is_lam, lz, jnp.where(is_met, gz + extra * uz, ez))
            il = jax.lax.rsqrt(jnp.maximum(sx * sx + sy * sy + sz * sz,
                                           1e-30))
            sx, sy, sz = sx * il, sy * il, sz * il
            scat = is_lam | is_die | (
                is_met & ((sx * nx + sy * ny + sz * nz) > 0.0))
            cont = hit & scat
            cw = cont.astype(jnp.float32)
            tr = jnp.where(cont & ~is_die, tr * c0, tr)
            tg = jnp.where(cont & ~is_die, tg * c1, tg)
            tb = jnp.where(cont & ~is_die, tb * c2, tb)
            if rr_depth > 0:
                # Russian roulette: survive with p = max channel, boost
                # survivors by 1/p (unbiased)
                p = jnp.clip(jnp.maximum(tr, jnp.maximum(tg, tb)), 0.05, 1.0)
                roul = depth >= rr_depth
                kill = roul & (_uniform01(rng, 4) >= p)
                boost = jnp.where(roul & ~kill & cont, 1.0 / p, 1.0)
                tr, tg, tb = tr * boost, tg * boost, tb * boost
                cw = jnp.where(kill, 0.0, cw)
            ox = jnp.where(cont, px, ox)
            oy = jnp.where(cont, py, oy)
            oz = jnp.where(cont, pz, oz)
            dx = jnp.where(cont, sx, dx)
            dy = jnp.where(cont, sy, dy)
            dz = jnp.where(cont, sz, dz)
            if n_lights:
                cw = cw * jnp.where(is_lam, 2.0, 1.0)
            return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, cw)

        def nee(rng, cand, px, py, pz, nx, ny, nz, tr, tg, tb, c0, c1, c2,
                rr, rg, rb):
            """Next-event estimation (ops/nee.py semantics): one light per
            lane, a direction toward it, an any-hit shadow walk, and the
            analytic direct term at Lambertian vertices."""
            lights = tab["lights"]
            u_l = _uniform01(rng, 5)
            u_a = _uniform01(rng, 6)
            u_b = _uniform01(rng, 7)
            li = jnp.where(cand, jnp.minimum((u_l * n_lights)
                                             .astype(jnp.int32),
                                             n_lights - 1), 0)
            L = _ld(lights, li, *range(28))
            (lkind, lord, lcx, lcy, lcz, lr, lux, luy, luz, lvx, lvy, lvz,
             lqx, lqy, lqz, ler, leg, leb) = L[:18]
            lcn, lcu, lcv, lr2 = L[18], L[22], L[26], L[27]
            lus, lvs = L[19:22], L[23:26]
            # sphere light: uniform cone toward the sphere
            tox, toy, toz = lcx - px, lcy - py, lcz - pz
            dc2 = tox * tox + toy * toy + toz * toz
            inv_dc = jax.lax.rsqrt(jnp.maximum(dc2, 1e-20))
            axx, axy, axz = tox * inv_dc, toy * inv_dc, toz * inv_dc
            sin2m = jnp.clip(lr * lr / jnp.maximum(dc2, 1e-20), 0.0, 1.0)
            cosm = jnp.sqrt(jnp.maximum(1.0 - sin2m, 0.0))
            cost = 1.0 - u_a * (1.0 - cosm)
            sint = jnp.sqrt(jnp.maximum(1.0 - cost * cost, 0.0))
            phi = TWO_PI * u_b
            hy = (jnp.abs(axx) > 0.9).astype(jnp.float32)
            hx = 1.0 - hy
            t1x, t1y, t1z = -axz * hy, axz * hx, axx * hy - axy * hx
            t_il = jax.lax.rsqrt(jnp.maximum(
                t1x * t1x + t1y * t1y + t1z * t1z, 1e-20))
            t1x, t1y, t1z = t1x * t_il, t1y * t_il, t1z * t_il
            t2x = axy * t1z - axz * t1y
            t2y = axz * t1x - axx * t1z
            t2z = axx * t1y - axy * t1x
            cp, sp = jnp.cos(phi) * sint, jnp.sin(phi) * sint
            wsx = axx * cost + t1x * cp + t2x * sp
            wsy = axy * cost + t1y * cp + t2y * sp
            wsz = axz * cost + t1z * cp + t2z * sp
            pdf_s = 1.0 / jnp.maximum(TWO_PI * (1.0 - cosm), 1e-12)
            s_ok = dc2 > lr * lr
            # quad light: uniform area -> solid-angle pdf
            a2, b2 = 2.0 * u_a - 1.0, 2.0 * u_b - 1.0
            qpx = lcx + a2 * lux + b2 * lvx - px
            qpy = lcy + a2 * luy + b2 * lvy - py
            qpz = lcz + a2 * luz + b2 * lvz - pz
            dist2 = qpx * qpx + qpy * qpy + qpz * qpz
            inv_dq = jax.lax.rsqrt(jnp.maximum(dist2, 1e-20))
            wqx, wqy, wqz = qpx * inv_dq, qpy * inv_dq, qpz * inv_dq
            crx = luy * lvz - luz * lvy
            cry = luz * lvx - lux * lvz
            crz = lux * lvy - luy * lvx
            area = 4.0 * jnp.sqrt(jnp.maximum(
                crx * crx + cry * cry + crz * crz, 0.0))
            cosl = jnp.abs(wqx * lqx + wqy * lqy + wqz * lqz)
            pdf_q = dist2 / jnp.maximum(cosl * area, 1e-12)
            q_ok = cosl > 1e-6

            is_s = lkind == float(KIND_SPHERE)
            wi = (jnp.where(is_s, wsx, wqx), jnp.where(is_s, wsy, wqy),
                  jnp.where(is_s, wsz, wqz))
            pdf = jnp.where(is_s, pdf_s, pdf_q) / float(n_lights)
            cos_s = wi[0] * nx + wi[1] * ny + wi[2] * nz
            p = (px, py, pz)
            t_s, ok_s = _sphere_t(p, wi, lcx, lcy, lcz, lr2, t_min)
            t_q, ok_q = _quad_t(p, wi, (lqx, lqy, lqz), lcn, lus, lcu, lvs,
                                lcv, t_min)
            t_l = jnp.where(is_s, t_s, t_q)
            cand = cand & (cos_s > 0.0) & jnp.where(
                is_s, s_ok & tcap(ok_s, t_s), q_ok & tcap(ok_q, t_q))
            vis = scene_hit(p, wi, cand, shadow=(t_l, lord))[0] >= 0.0
            w = (cos_s / (math.pi * jnp.maximum(pdf, 1e-12))) \
                * (cand & vis).astype(jnp.float32)
            return (rr + tr * c0 * w * ler, rg + tg * c1 * w * leg,
                    rb + tb * c2 * w * leb)

        def cond(c):
            return (c[0] < n_bounces) & (jnp.max(c[1][12]) > 0.0)

        def body(c):
            i, st = c
            return i + 1, bounce(depth0 + i, st)

        if out == "hit":
            h = scene_hit(state[0:3], state[3:6], state[12] > 0.0)
            found = (h[_T] < BIG) & (h[_T] >= 0.0)
            res = (jnp.where(found, h[_T], jnp.inf),
                   jnp.where(found, h[_ORD], -1.0).astype(jnp.int32))
        else:
            _, state = jax.lax.while_loop(cond, body,
                                          (jnp.int32(0), state))
            res = state if out == "state" else state[9:12]
        for ref, v in zip(outs, res):
            ref[...] = v

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "n_bounces", "out", "t_min", "t_max", "rr_depth", "interpret"))
def _launch(tables: SceneTables, scalars, pix, planes, *, n_bounces: int,
            out: str, t_min: float, t_max: float, rr_depth: int,
            interpret: bool):
    names, arrays = tables.inputs()
    r = pix.shape[0]
    assert r % BLOCK == 0, (r, BLOCK)
    kernel = _make_kernel(names, len(planes), n_bounces, out, t_min,
                          t_max, rr_depth, tables.sky, tables.checker,
                          tables.itex)
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    f32 = jax.ShapeDtypeStruct((r,), jnp.float32)
    out_shape = {"radiance": [f32] * 3, "state": [f32] * 13,
                 "hit": [f32, jax.ShapeDtypeStruct((r,), jnp.int32)]}[out]
    n_out = len(out_shape)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(r // BLOCK,),
        in_specs=[whole(scalars), ray, *[ray] * len(planes),
                  *[whole(a) for a in arrays]],
        out_specs=[ray] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="trace_paths",
    )(scalars, pix, *planes, *arrays)


def check_platform(interpret: bool) -> None:
    """The kernel compiles for CUDA GPUs only.  Elsewhere it runs only in
    Triton interpret mode, and only when the caller asks for it."""
    if interpret:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"the trace kernel needs a CUDA GPU, found platform "
            f"{platform!r}; pass interpret=True to run it in Triton "
            f"interpret mode (tests)")


def _scalars(seed, depth0, count):
    return jnp.stack([jnp.asarray(seed, jnp.int32).reshape(()),
                      jnp.asarray(depth0, jnp.int32),
                      jnp.asarray(count, jnp.int32),
                      jnp.int32(0)])


def padded(r: int) -> int:
    """Ray count rounded up to whole blocks."""
    return r + (-r) % BLOCK


def ray_planes(o, d):
    """(R, 3) origins and directions -> six (Rp,) planes padded to whole
    blocks (pad rays point along +z and are dead: slot >= count)."""
    pad = padded(o.shape[0]) - o.shape[0]

    def plane(x, c=0.0):
        return jnp.pad(x, (0, pad), constant_values=c) if pad else x

    return (plane(o[:, 0]), plane(o[:, 1]), plane(o[:, 2]),
            plane(d[:, 0]), plane(d[:, 1]), plane(d[:, 2], 1.0))


def closest_hit(tables: SceneTables, o, d, cfg,
                interpret: bool = False) -> Tuple[jax.Array, jax.Array]:
    """(t, ordinal) of the closest hit of each ray (o, d (R, 3)): t is
    inf and the ordinal -1 on a miss.  Ordinals are global (spheres,
    then quads, then triangles, ops/intersect.py), so the result
    compares with the jnp oracle directly."""
    r = o.shape[0]
    planes = ray_planes(o, d)
    pix = jnp.zeros(planes[0].shape, jnp.int32)
    t, ordv = _launch(tables, _scalars(0, 0, r), pix, planes, n_bounces=0,
                      out="hit", t_min=cfg.t_min, t_max=cfg.t_max,
                      rr_depth=0, interpret=interpret)
    return t[:r], ordv[:r]


def trace_paths(tables: SceneTables, o, d, pix, seed, cfg,
                interpret: bool = False) -> jax.Array:
    """(R, 3) radiance of R camera rays (o, d (R, 3)) through
    cfg.max_depth bounces.  pix (R,) int32 pixel ids key the RNG."""
    r = o.shape[0]
    planes = ray_planes(o, d)
    pad = planes[0].shape[0] - r
    plane = lambda x: jnp.pad(x, (0, pad)) if pad else x
    out = _launch(tables, _scalars(seed, 0, r),
                  plane(pix.astype(jnp.int32)), planes,
                  n_bounces=cfg.max_depth, out="radiance",
                  t_min=cfg.t_min, t_max=cfg.t_max,
                  rr_depth=cfg.russian_roulette_depth, interpret=interpret)
    return jnp.stack(out, axis=1)[:r]


def trace_segment(tables: SceneTables, pix, state, seed, depth0, count,
                  n_bounces: int, cfg, interpret: bool = False):
    """n_bounces of the path loop over a queue of rays.

    pix: (R,) int32 pixel ids, R a multiple of BLOCK; state: 13 (R,) f32
    planes (ox oy oz dx dy dz tr tg tb rr rg rb alive), or the first six
    of them for camera rays (unit throughput, no radiance yet, alive);
    slots >= count are dead.  alive == 2 carries NEE's no-emission mark
    across segments.  Returns the 13 updated planes."""
    return tuple(_launch(tables, _scalars(seed, depth0, count), pix,
                         tuple(state), n_bounces=n_bounces, out="state",
                         t_min=cfg.t_min, t_max=cfg.t_max,
                         rr_depth=cfg.russian_roulette_depth,
                         interpret=interpret))
