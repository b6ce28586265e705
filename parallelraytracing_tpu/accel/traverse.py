"""Vectorized stackless BVH traversal.

The JAX analogue of the reference's OptiX raygen/IS/CH pipeline
(optix/device_programs.cu:161-511): each ray walks the threaded preorder
layout of accel/lbvh.py — hit continues to node+1, miss jumps the escape
link — so the whole batch advances in lockstep vector steps with no
per-lane stack.  Leaf hits run the same sphere/quad/triangle tests and
front-face rules as the brute-force path (ops/intersect.py), so BVH and
brute-force intersections agree exactly.

All node/primitive fetches are dynamic gathers; the loop is a
`lax.while_loop` that ends when every lane has terminated.  Slab tests are
clipped against each lane's current best t, giving ordered early-out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.accel.lbvh import BVHData
from parallelraytracing_tpu.core.scene import (
    KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, SceneData)
from parallelraytracing_tpu.ops.intersect import HitRecord, resolve_hit

_BIG = 3.0e38  # plain float: keeps package import from initializing a jax backend


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def bvh_intersect_scene(scene: SceneData, bvh: BVHData, o: jax.Array,
                        d: jax.Array, t_min: float, t_max: float) -> HitRecord:
    """Closest hit via threaded-BVH traversal. o,d: (R,3), d unit."""
    r = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)

    node0 = jnp.zeros((r,), jnp.int32)
    best = (jnp.full((r,), _BIG), jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r,), jnp.int32), jnp.zeros((r,), bool),
            jnp.full((r,), 2**30, jnp.int32))

    def cond(state):
        node, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, best = state
        best_t, best_kind, best_idx, best_front, best_ord = best
        active = node >= 0
        n = jnp.maximum(node, 0)

        bmin = bvh.node_min[n]
        bmax = bvh.node_max[n]
        kind = bvh.node_kind[n]
        pidx = bvh.node_idx[n]
        pord = bvh.node_ord[n]
        miss_link = bvh.node_miss[n]

        # Slab test clipped by the lane's current best t.
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=1)
        box_hit = (tn <= tf) & (tf >= t_min) & (tn <= jnp.minimum(best_t, t_max))

        is_leaf = kind >= 0

        # ---- leaf primitive tests (masked, all three kinds) ----
        do_leaf = active & is_leaf & box_hit

        # Sphere (shape.h:157-203 semantics)
        si = jnp.clip(pidx, 0, scene.sph_center.shape[0] - 1)
        sc = scene.sph_center[si]
        sr = scene.sph_radius[si]
        oc = o - sc
        b2 = _dot(d, oc)
        c = _dot(oc, oc) - sr * sr
        disc = b2 * b2 - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        s_near = -b2 - sq
        s_far = -b2 + sq
        s_front = s_near >= t_min
        s_t = jnp.where(s_front, s_near, s_far)
        s_ok = (disc >= 0.0) & (s_t >= t_min) & (s_t <= t_max)

        # Quad (shape.h:213-239 baked to world space)
        qi = jnp.clip(pidx, 0, scene.quad_normal.shape[0] - 1)
        qn = scene.quad_normal[qi]
        qc = scene.quad_center[qi]
        qu = scene.quad_u[qi]
        qv = scene.quad_v[qi]
        dn = _dot(d, qn)
        q_ok_denom = jnp.abs(dn) >= 1e-8
        q_t = jnp.where(q_ok_denom, _dot(qc - o, qn) / jnp.where(q_ok_denom, dn, 1.0), 0.0)
        qp = o + q_t[:, None] * d - qc
        qa = _dot(qp, qu) / jnp.maximum(_dot(qu, qu), 1e-30)
        qb = _dot(qp, qv) / jnp.maximum(_dot(qv, qv), 1e-30)
        q_ok = (q_ok_denom & (q_t > t_min) & (q_t <= t_max)
                & (qa * qa < 1.0) & (qb * qb < 1.0))
        q_front = _dot(o - qc, qn) > 0.0

        # Triangle (Moller-Trumbore, shape.h:262-303)
        ti = jnp.clip(pidx, 0, scene.tri_v0.shape[0] - 1)
        v0 = scene.tri_v0[ti]
        e1 = scene.tri_v1[ti] - v0
        e2 = scene.tri_v2[ti] - v0
        sv = o - v0
        s1 = jnp.cross(d, e2)
        s2 = jnp.cross(sv, e1)
        div = _dot(s1, e1)
        t_ok_div = div != 0.0
        inv = jnp.where(t_ok_div, 1.0 / jnp.where(t_ok_div, div, 1.0), 0.0)
        t_t = _dot(s2, e2) * inv
        b1 = _dot(s1, sv) * inv
        bb2 = _dot(s2, d) * inv
        t_ok = (t_ok_div & (t_t >= t_min) & (t_t <= t_max)
                & (b1 >= 0.0) & (bb2 >= 0.0) & (b1 + bb2 <= 1.0))

        leaf_t = jnp.where(kind == KIND_SPHERE, s_t,
                           jnp.where(kind == KIND_QUAD, q_t, t_t))
        leaf_ok = jnp.where(kind == KIND_SPHERE, s_ok,
                            jnp.where(kind == KIND_QUAD, q_ok, t_ok))
        leaf_front = jnp.where(kind == KIND_SPHERE, s_front,
                               jnp.where(kind == KIND_QUAD, q_front, True))

        # Strict < with lowest-ordinal tie-break: matches the reference's
        # first-wins primitive-list order for coplanar equal-t hits.
        upd = do_leaf & leaf_ok & (
            (leaf_t < best_t) | ((leaf_t == best_t) & (pord < best_ord)))
        best_t = jnp.where(upd, leaf_t, best_t)
        best_kind = jnp.where(upd, kind, best_kind)
        best_idx = jnp.where(upd, pidx, best_idx)
        best_front = jnp.where(upd, leaf_front, best_front)
        best_ord = jnp.where(upd, pord, best_ord)

        # ---- advance ----
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, n + 1, miss_link)
        node = jnp.where(active, nxt, node)
        return node, (best_t, best_kind, best_idx, best_front, best_ord)

    _, best = jax.lax.while_loop(cond, body, (node0, best))
    best_t, best_kind, best_idx, best_front, _ = best
    return resolve_hit(scene, o, d,
                       jnp.where(best_kind >= 0, best_t, _BIG),
                       best_kind, best_idx, best_front, t_min)
