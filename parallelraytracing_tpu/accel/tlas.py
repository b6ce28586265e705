"""Two-level acceleration structure (TLAS over instances, BLAS per mesh).

The JAX form of the reference's OptiX instance acceleration
structure (IAS over per-geometry GASes with per-instance transforms,
optix/renderer.cpp:833-870): each unique mesh gets ONE threaded LBVH over
its LOCAL-space triangles (the BLAS), instances are {blas, transform,
inverse transform, material} records, and a small threaded TLAS over the
instances' world AABBs routes rays.  A ray entering an instance leaf is
transformed into mesh-local space by the inverse transform WITHOUT
renormalizing the direction, so the local hit parameter t equals the
world-space t and closest-hit composition across instances and
non-instanced primitives needs no rescaling (the standard
instancing identity; the reference gets it from OptiX's
transform handling).

Memory is proportional to UNIQUE meshes: Scene.add_mesh_instances
stores each mesh once, never a world-space copy per instance.

Traversal is the same per-lane threaded walk as accel/traverse.py with a
2-deep implicit stack: a lane is either walking the TLAS (blas cursor
-1) or inside one BLAS (blas cursor = global node index); BLAS exit
returns to the saved TLAS escape link.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu.accel.lbvh import build_threaded
from parallelraytracing_tpu.core import geometry as geo

_BIG = 3.0e38


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TwoLevelBVH:
    """Device arrays for TLAS + concatenated BLAS + local triangle soup."""

    # TLAS (threaded preorder over instances; t_inst = -1 for internal).
    t_min: jax.Array   # (Mt,3) f32
    t_max: jax.Array   # (Mt,3)
    t_miss: jax.Array  # (Mt,) i32
    t_inst: jax.Array  # (Mt,) i32

    # Instances.
    inst_root: jax.Array  # (Ni,) i32 global node index of the BLAS root
    inst_inv: jax.Array   # (Ni,3,4) f32 world->local affine
    inst_nrm: jax.Array   # (Ni,3,3) f32 local normal -> world (inv^T)
    inst_mat: jax.Array   # (Ni,) i32 material id

    # Concatenated BLAS nodes (threaded; miss links are GLOBAL indices,
    # -1 = exit the BLAS back to the TLAS; b_tri = -1 for internal).
    b_min: jax.Array   # (Mb,3)
    b_max: jax.Array   # (Mb,3)
    b_miss: jax.Array  # (Mb,) i32
    b_tri: jax.Array   # (Mb,) i32 index into the local triangle soup

    # Local triangle soup (concatenated across unique meshes).
    v0: jax.Array  # (Nt,3)
    v1: jax.Array
    v2: jax.Array
    n0: jax.Array
    n1: jax.Array
    n2: jax.Array

    @property
    def num_instances(self) -> int:
        return int(self.inst_mat.shape[0])

    @property
    def num_unique_triangles(self) -> int:
        return int(self.v0.shape[0])


def _mesh_local_arrays(mesh) -> Tuple[np.ndarray, ...]:
    verts = np.asarray(mesh.vertices, np.float64)
    idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    if mesh.normals is not None and len(mesh.normals) == len(verts):
        nrm = np.asarray(mesh.normals, np.float64)
        lens = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(lens, 1e-30)
        n0, n1, n2 = nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]
    else:
        gn = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(gn, axis=1, keepdims=True)
        gn = np.where(ln > 0, gn / np.maximum(ln, 1e-30),
                      np.array([0.0, 1.0, 0.0]))
        n0 = n1 = n2 = gn
    return v0, v1, v2, n0, n1, n2


def build_two_level(meshes: Sequence, instances: Sequence[Tuple[int, int,
                                                                np.ndarray]],
                    dtype=jnp.float32) -> TwoLevelBVH:
    """meshes: unique Mesh objects; instances: (mesh_index, material_id,
    4x4 world transform) records."""
    assert len(instances) >= 1, "TLAS needs at least one instance"

    # --- BLAS per unique mesh, concatenated.
    tri_arrays: List[np.ndarray] = [[] for _ in range(6)]
    b_min: List[np.ndarray] = []
    b_max: List[np.ndarray] = []
    b_miss: List[np.ndarray] = []
    b_tri: List[np.ndarray] = []
    mesh_root = []     # global root node index per mesh
    mesh_bbox = []     # local root AABB per mesh
    node_off = 0
    tri_off = 0
    for mesh in meshes:
        v0, v1, v2, n0, n1, n2 = _mesh_local_arrays(mesh)
        for a, arr in zip(tri_arrays, (v0, v1, v2, n0, n1, n2)):
            a.append(arr)
        mn = np.minimum(np.minimum(v0, v1), v2)
        mx = np.maximum(np.maximum(v0, v1), v2)
        nmn, nmx, is_leaf, payload, miss = build_threaded(mn, mx)
        m = len(miss)
        b_min.append(nmn)
        b_max.append(nmx)
        # Thread links globally; -1 stays -1 (= exit BLAS).
        gmiss = np.where(miss >= 0, miss + node_off, -1)
        b_miss.append(gmiss)
        gtri = np.where(is_leaf, payload + tri_off, -1)
        b_tri.append(gtri)
        mesh_root.append(node_off)
        mesh_bbox.append((nmn[0], nmx[0]))  # preorder root = node 0
        node_off += m
        tri_off += len(v0)

    # --- instance records + world AABBs.
    inst_root = []
    inst_inv = []
    inst_nrm = []
    inst_mat = []
    w_mn = []
    w_mx = []
    for mesh_i, mat_id, m4 in instances:
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)
        inst_root.append(mesh_root[mesh_i])
        inst_inv.append(inv[:3, :4])
        inst_nrm.append(inv[:3, :3].T)  # inverse-transpose linear part
        inst_mat.append(mat_id)
        lo, hi = mesh_bbox[mesh_i]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        wc = corners @ m4[:3, :3].T + m4[:3, 3]
        w_mn.append(wc.min(0))
        w_mx.append(wc.max(0))

    # --- TLAS over instance world boxes.
    tmn, tmx, t_leaf, t_payload, t_miss = build_threaded(
        np.asarray(w_mn), np.asarray(w_mx))
    t_inst = np.where(t_leaf, t_payload, -1)

    f = lambda a: jnp.asarray(np.concatenate(a) if isinstance(a, list)
                              else a, dtype)
    i32 = lambda a: jnp.asarray(np.concatenate(a) if isinstance(a, list)
                                else a, jnp.int32)
    return TwoLevelBVH(
        t_min=jnp.asarray(tmn, dtype), t_max=jnp.asarray(tmx, dtype),
        t_miss=jnp.asarray(t_miss, jnp.int32),
        t_inst=jnp.asarray(t_inst, jnp.int32),
        inst_root=jnp.asarray(inst_root, jnp.int32),
        inst_inv=jnp.asarray(np.asarray(inst_inv), dtype),
        inst_nrm=jnp.asarray(np.asarray(inst_nrm), dtype),
        inst_mat=jnp.asarray(inst_mat, jnp.int32),
        b_min=f(b_min), b_max=f(b_max),
        b_miss=i32(b_miss), b_tri=i32(b_tri),
        v0=f(tri_arrays[0]), v1=f(tri_arrays[1]), v2=f(tri_arrays[2]),
        n0=f(tri_arrays[3]), n1=f(tri_arrays[4]), n2=f(tri_arrays[5]),
    )


def _slab(o, inv_d, bmin, bmax, t_min, best_t):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=1)
    return (tn <= tf) & (tf >= t_min) & (tn <= best_t)


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                           jnp.where(d < 0, -1e-20, 1e-20), d)


def tlas_intersect(tl: TwoLevelBVH, o: jax.Array, d: jax.Array,
                   t_min: float, t_max: float):
    """Closest instanced-triangle hit.  o,d: (R,3) world rays (d unit).

    Returns (t, inst, tri, b1, b2): world-space distance (BIG on miss),
    winning instance / local-triangle indices and barycentrics."""
    r = o.shape[0]
    inv_d = _safe_inv(d)

    state = dict(
        tn=jnp.zeros((r,), jnp.int32),            # TLAS cursor
        bn=jnp.full((r,), -1, jnp.int32),         # BLAS cursor (-1 = TLAS)
        esc=jnp.full((r,), -1, jnp.int32),        # TLAS resume link
        inst=jnp.zeros((r,), jnp.int32),          # active instance
        lo=o, ld=d, linv=inv_d,                   # local-space ray
        bt=jnp.full((r,), _BIG), bi=jnp.zeros((r,), jnp.int32),
        bj=jnp.zeros((r,), jnp.int32),
        bb1=jnp.zeros((r,)), bb2=jnp.zeros((r,)),
    )
    keys = tuple(state.keys())

    def cond(vals):
        s = dict(zip(keys, vals))
        return jnp.any((s["tn"] >= 0) | (s["bn"] >= 0))

    def body(vals):
        s = dict(zip(keys, vals))
        in_blas = s["bn"] >= 0
        active_t = (~in_blas) & (s["tn"] >= 0)

        # ---------------- TLAS step (world-space ray)
        n = jnp.maximum(s["tn"], 0)
        hit_t = _slab(o, inv_d, tl.t_min[n], tl.t_max[n], t_min,
                      jnp.minimum(s["bt"], t_max))
        inst = tl.t_inst[n]
        miss_t = tl.t_miss[n]
        is_leaf_t = inst >= 0
        enter = active_t & hit_t & is_leaf_t

        # Enter instance: local ray via the inverse affine (direction NOT
        # renormalized -> local t == world t).
        ii = jnp.clip(inst, 0, tl.num_instances - 1)
        inv = tl.inst_inv[ii]                       # (R,3,4)
        # HIGHEST: a TF32 product would crack the instance-space rays
        hi = jax.lax.Precision.HIGHEST
        lo_new = jnp.einsum("rij,rj->ri", inv[:, :, :3], o,
                            precision=hi) + inv[:, :, 3]
        ld_new = jnp.einsum("rij,rj->ri", inv[:, :, :3], d, precision=hi)
        s["lo"] = jnp.where(enter[:, None], lo_new, s["lo"])
        s["ld"] = jnp.where(enter[:, None], ld_new, s["ld"])
        s["linv"] = jnp.where(enter[:, None], _safe_inv(ld_new), s["linv"])
        s["inst"] = jnp.where(enter, inst, s["inst"])
        s["esc"] = jnp.where(enter, miss_t, s["esc"])
        s["bn"] = jnp.where(enter, tl.inst_root[ii], s["bn"])

        descend_t = active_t & hit_t & ~is_leaf_t
        tn_next = jnp.where(descend_t, n + 1, miss_t)
        # Lanes that just entered a BLAS park their TLAS cursor on the
        # escape link (resumed when the BLAS exits).
        s["tn"] = jnp.where(active_t & ~enter, tn_next,
                            jnp.where(enter, miss_t, s["tn"]))

        # ---------------- BLAS step (local-space ray)
        in_blas = s["bn"] >= 0  # includes lanes that entered this round
        bnode = jnp.maximum(s["bn"], 0)
        hit_b = _slab(s["lo"], s["linv"], tl.b_min[bnode], tl.b_max[bnode],
                      t_min, jnp.minimum(s["bt"], t_max))
        tri = tl.b_tri[bnode]
        miss_b = tl.b_miss[bnode]
        is_leaf_b = tri >= 0

        # Leaf triangle test (Moller-Trumbore, local space).
        ti = jnp.clip(tri, 0, tl.num_unique_triangles - 1)
        tv0 = tl.v0[ti]
        e1 = tl.v1[ti] - tv0
        e2 = tl.v2[ti] - tv0
        sv = s["lo"] - tv0
        s1 = jnp.cross(s["ld"], e2)
        s2 = jnp.cross(sv, e1)
        div = jnp.sum(s1 * e1, axis=1)
        div_ok = div != 0.0
        inv_div = jnp.where(div_ok, 1.0 / jnp.where(div_ok, div, 1.0), 0.0)
        tt = jnp.sum(s2 * e2, axis=1) * inv_div
        b1 = jnp.sum(s1 * sv, axis=1) * inv_div
        b2 = jnp.sum(s2 * s["ld"], axis=1) * inv_div
        t_ok = (div_ok & (tt >= t_min) & (tt <= t_max)
                & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0))
        upd = in_blas & is_leaf_b & hit_b & t_ok & (tt < s["bt"])
        s["bt"] = jnp.where(upd, tt, s["bt"])
        s["bi"] = jnp.where(upd, s["inst"], s["bi"])
        s["bj"] = jnp.where(upd, tri, s["bj"])
        s["bb1"] = jnp.where(upd, b1, s["bb1"])
        s["bb2"] = jnp.where(upd, b2, s["bb2"])

        descend_b = hit_b & ~is_leaf_b
        bn_next = jnp.where(descend_b, bnode + 1, miss_b)
        s["bn"] = jnp.where(in_blas, bn_next, s["bn"])
        # BLAS exit (miss link -1): resume the TLAS at the saved escape.
        exited = in_blas & (s["bn"] < 0)
        s["tn"] = jnp.where(exited, s["esc"], s["tn"])

        return tuple(s[k] for k in keys)

    vals = jax.lax.while_loop(cond, body, tuple(state.values()))
    s = dict(zip(keys, vals))
    return s["bt"], s["bi"], s["bj"], s["bb1"], s["bb2"]


def resolve_instanced_hit(tl: TwoLevelBVH, o, d, t, inst, tri, b1, b2):
    """World-space position/normal/material of the winning instanced
    triangle (t==BIG lanes produce garbage; callers mask by t)."""
    ii = jnp.clip(inst, 0, tl.num_instances - 1)
    ti = jnp.clip(tri, 0, tl.num_unique_triangles - 1)
    b0 = 1.0 - b1 - b2
    nl = (b0[:, None] * tl.n0[ti] + b1[:, None] * tl.n1[ti]
          + b2[:, None] * tl.n2[ti])
    nrm = tl.inst_nrm[ii]                          # (R,3,3)
    nw = jnp.einsum("rij,rj->ri", nrm, nl,
                    precision=jax.lax.Precision.HIGHEST)
    back = jnp.sum(nw * d, axis=1) > 0.0           # shape.h:294-302 flip
    nw = jnp.where(back[:, None], -nw, nw)
    nw = nw / jnp.maximum(jnp.linalg.norm(nw, axis=1, keepdims=True), 1e-30)
    pos = o + t[:, None] * d
    mat = tl.inst_mat[ii]
    return pos, nw, ~back, mat
