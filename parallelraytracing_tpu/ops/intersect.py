"""Brute-force closest-hit intersection over the whole scene.

The JAX replacement for the reference's O(N) primitive loops
(cuda_megakernel/renderer.cu:41-79, cuda_wavefront/renderer.cu:244-261,
primitive.cpp:21-59): instead of one thread looping over primitives, all
rays are tested against primitive *chunks* at once, with the per-(ray,prim)
quantities factored into broadcast 3-term contractions (_rk_dot) plus
elementwise math, and a running closest-hit fold carried through a
`lax.scan` over chunks — so the working set stays O(R * chunk), never
O(R * N * 3).

Geometry semantics match the reference exactly:
- sphere: quadratic with front-face logic (both roots >= tMin -> front,
  near root; else far root, back face), shape.h:157-203;
- quad: local y=0 plane hit with half-extent test and front = origin above
  the plane, shape.h:213-239 (here in world space against baked
  center/edge/normal, like optix/device_programs.cu:376-410);
- triangle: Moller-Trumbore with interpolated vertex normals and backface
  flip, shape.h:262-303 (the dot products are re-associated into scalar
  triple products so per-chunk work is ray-constant x prim-constant
  contractions);
- closest-hit by world-space distance (with unit directions t == distance),
  matching the squared-distance / length orderings of the reference
  backends (cuda_megakernel/renderer.cu:59-67,
  cuda_wavefront/renderer.cu:250).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.core.scene import (
    KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, SceneData)

_BIG = 3.0e38  # plain float: keeps package import from initializing a jax backend


def _rk_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """(R,3)x(K,3) -> (R,K) contraction as explicit broadcast FMAs.

    Deliberately NOT a matmul: a reduced-precision matmul (TF32 on
    GPU tensor cores, XLA's default for f32 dots) destroys the
    intersection discriminants (values ~1e3 would lose ~1 absolute
    precision and the image grows corduroy artifacts).  A K=3
    contraction gains nothing from matrix units anyway — three
    elementwise FMAs are both exact-f32 and faster."""
    return (a[:, 0:1] * b[None, :, 0]
            + a[:, 1:2] * b[None, :, 1]
            + a[:, 2:3] * b[None, :, 2])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SurfaceInteraction analogue (surface_interaction.h:6-13) plus the
    winning primitive's identity."""

    t: jax.Array       # (R,) f32, world distance (inf on miss)
    hit: jax.Array     # (R,) bool
    pos: jax.Array     # (R,3)
    normal: jax.Array  # (R,3) unit, flipped toward the incoming ray side
    front: jax.Array   # (R,) bool
    mat: jax.Array     # (R,) i32 material id (0 on miss)
    kind: jax.Array    # (R,) i32 primitive kind (KIND_*)
    idx: jax.Array     # (R,) i32 index within its kind
    # Surface UV — populated by resolve_hit only on image-textured scenes
    # (None otherwise, so untextured pytrees keep their shape).
    uv: "jax.Array | None" = None


def _pad_chunks(arrs, valid, chunk):
    """Pad leading dim to a multiple of `chunk` and reshape each array to
    (n_chunks, chunk, ...). Returns (padded arrays, padded valid)."""
    n = valid.shape[0]
    k = min(chunk, max(n, 1))
    n_pad = (-n) % k
    out = []
    for a in arrs:
        pad_width = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
        p = jnp.pad(a, pad_width)
        out.append(p.reshape((n + n_pad) // k, k, *a.shape[1:]))
    v = jnp.pad(valid, (0, n_pad), constant_values=False)
    return out, v.reshape((n + n_pad) // k, k)


def _fold_best(carry, t, hit, front, idx_base, kind, ord_base):
    """Fold chunk results (R,K) into the running closest-hit carry.

    Ties at identical t resolve to the lowest GLOBAL ordinal
    (ord = kind offset + within-kind index, the same convention as the BVH
    and kernel paths), matching the reference's strict-< first-wins scan
    (primitive.cpp:42-48).  Within a chunk argmin already picks the lowest
    index; across chunks/kinds the carried ordinal decides."""
    best_t, best_kind, best_idx, best_front, best_ord = carry
    t = jnp.where(hit, t, _BIG)
    chunk_min = jnp.min(t, axis=1)
    chunk_arg = jnp.argmin(t, axis=1).astype(jnp.int32)
    rows = jnp.arange(t.shape[0])
    chunk_front = front[rows, chunk_arg] if front is not None else jnp.ones_like(chunk_min, dtype=bool)
    chunk_ord = ord_base + idx_base + chunk_arg
    better = (chunk_min < best_t) | (
        (chunk_min == best_t) & (chunk_min < _BIG) & (chunk_ord < best_ord))
    return (
        jnp.where(better, chunk_min, best_t),
        jnp.where(better, jnp.int32(kind), best_kind),
        jnp.where(better, idx_base + chunk_arg, best_idx),
        jnp.where(better, chunk_front, best_front),
        jnp.where(better, chunk_ord, best_ord),
    )


# ----------------------------------------------------------------- spheres

def _sphere_chunk(o, d, do, oo, center, radius, valid, t_min, t_max):
    """Per-chunk sphere test. o,d: (R,3); do=dot(d,o) (R,); oo=|o|^2 (R,).
    center (K,3), radius (K,). Returns t (R,K), hit, front."""
    # b/2 = dot(d, o - c); c_term = |o - c|^2 - r^2
    dc = _rk_dot(d, center)                       # (R,K)
    ocn = _rk_dot(o, center)                      # (R,K)
    cc = jnp.sum(center * center, axis=1) - radius * radius  # (K,)
    b2 = do[:, None] - dc
    c_term = oo[:, None] - 2.0 * ocn + cc[None, :]
    disc = b2 * b2 - c_term
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = -b2 - sq
    t_far = -b2 + sq
    front = t_near >= t_min
    t = jnp.where(front, t_near, t_far)
    hit = (disc >= 0.0) & (t >= t_min) & (t <= t_max) & valid[None, :]
    return t, hit, front


# ------------------------------------------------------------------- quads

def _quad_chunk(o, d, n, cn, us, cu, vs, cv, valid, t_min, t_max):
    """n (K,3) unit normal; cn = center.n (K,); us = u/|u|^2 (K,3);
    cu = center.us (K,); likewise vs, cv."""
    dn = _rk_dot(d, n)                    # (R,K)
    on = _rk_dot(o, n)                    # (R,K)
    denom_ok = jnp.abs(dn) >= 1e-8  # shape.h:215 degenerate guard
    inv_dn = jnp.where(denom_ok, 1.0 / jnp.where(denom_ok, dn, 1.0), 0.0)
    t = (cn[None, :] - on) * inv_dn
    a = _rk_dot(o, us) + t * _rk_dot(d, us) - cu[None, :]
    b = _rk_dot(o, vs) + t * _rk_dot(d, vs) - cv[None, :]
    hit = (denom_ok & (t > t_min) & (t <= t_max)
           & (a * a < 1.0) & (b * b < 1.0) & valid[None, :])
    front = (on - cn[None, :]) > 0.0  # local origin.y > 0 (shape.h:232)
    return t, hit, front


# --------------------------------------------------------------- triangles

def _tri_chunk(o, d, w, ng, p0ng, e1, e2, e2xp0, p0xe1, valid, t_min, t_max):
    """Moller-Trumbore via triple products. w = cross(o, d) (R,3).
    ng = cross(e1,e2) (K,3); p0ng = v0.ng (K,); e2xp0 = cross(e2,v0);
    p0xe1 = cross(v0,e1)."""
    div = -_rk_dot(d, ng)                       # divisor = dot(d, e2 x e1)
    div_ok = div != 0.0
    inv = jnp.where(div_ok, 1.0 / jnp.where(div_ok, div, 1.0), 0.0)
    t = (_rk_dot(o, ng) - p0ng[None, :]) * inv
    b1 = (_rk_dot(w, e2) - _rk_dot(d, e2xp0)) * inv
    b2 = (-_rk_dot(w, e1) - _rk_dot(d, p0xe1)) * inv
    hit = (div_ok & (t >= t_min) & (t <= t_max)
           & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & valid[None, :])
    return t, hit, None


# ------------------------------------------------------------------ driver

def intersect_scene(scene: SceneData, o: jax.Array, d: jax.Array,
                    t_min: float, t_max: float, chunk: int = 256) -> HitRecord:
    """Closest hit of rays (o, d) against every primitive. o,d: (R,3)."""
    r = o.shape[0]
    do = jnp.sum(d * o, axis=1)
    oo = jnp.sum(o * o, axis=1)
    w = jnp.cross(o, d)

    carry = (jnp.full((r,), _BIG), jnp.full((r,), -1, jnp.int32),
             jnp.zeros((r,), jnp.int32), jnp.zeros((r,), bool),
             jnp.full((r,), 2**30, jnp.int32))

    # Global ordinal offsets: spheres, then quads, then triangles — shared
    # with accel/lbvh.py and ops/trace_kernel.py so equal-t ties resolve to
    # the same primitive on every path.
    n_sph = scene.sph_center.shape[0]
    n_quad = scene.quad_normal.shape[0]

    # Spheres
    (c_ck, r_ck), v_ck = _pad_chunks(
        [scene.sph_center, scene.sph_radius], scene.sph_valid, chunk)
    k = c_ck.shape[1]

    def sph_step(carry, inp):
        i, center, radius, valid = inp
        t, hit, front = _sphere_chunk(o, d, do, oo, center, radius, valid,
                                      t_min, t_max)
        return _fold_best(carry, t, hit, front, i * k, KIND_SPHERE, 0), None

    idxs = jnp.arange(c_ck.shape[0], dtype=jnp.int32)
    carry, _ = jax.lax.scan(sph_step, carry, (idxs, c_ck, r_ck, v_ck))

    # Quads
    qn = scene.quad_normal
    qc = scene.quad_center
    qu, qv = scene.quad_u, scene.quad_v
    us = qu / jnp.maximum(jnp.sum(qu * qu, axis=1, keepdims=True), 1e-30)
    vs = qv / jnp.maximum(jnp.sum(qv * qv, axis=1, keepdims=True), 1e-30)
    cn = jnp.sum(qc * qn, axis=1)
    cu = jnp.sum(qc * us, axis=1)
    cv = jnp.sum(qc * vs, axis=1)
    (n_ck, cn_ck, us_ck, cu_ck, vs_ck, cv_ck), qv_ck = _pad_chunks(
        [qn, cn, us, cu, vs, cv], scene.quad_valid, chunk)
    kq = n_ck.shape[1]

    def quad_step(carry, inp):
        i, n_, cn_, us_, cu_, vs_, cv_, valid = inp
        t, hit, front = _quad_chunk(o, d, n_, cn_, us_, cu_, vs_, cv_, valid,
                                    t_min, t_max)
        return _fold_best(carry, t, hit, front, i * kq, KIND_QUAD,
                          n_sph), None

    idxs = jnp.arange(n_ck.shape[0], dtype=jnp.int32)
    carry, _ = jax.lax.scan(
        quad_step, carry, (idxs, n_ck, cn_ck, us_ck, cu_ck, vs_ck, cv_ck, qv_ck))

    # Triangles
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    ng = jnp.cross(e1, e2)
    p0ng = jnp.sum(scene.tri_v0 * ng, axis=1)
    e2xp0 = jnp.cross(e2, scene.tri_v0)
    p0xe1 = jnp.cross(scene.tri_v0, e1)
    (ng_ck, p0ng_ck, e1_ck, e2_ck, e2xp0_ck, p0xe1_ck), tv_ck = _pad_chunks(
        [ng, p0ng, e1, e2, e2xp0, p0xe1], scene.tri_valid, chunk)
    kt = ng_ck.shape[1]

    def tri_step(carry, inp):
        i, ng_, p0ng_, e1_, e2_, e2xp0_, p0xe1_, valid = inp
        t, hit, front = _tri_chunk(o, d, w, ng_, p0ng_, e1_, e2_, e2xp0_,
                                   p0xe1_, valid, t_min, t_max)
        return _fold_best(carry, t, hit, front, i * kt, KIND_TRIANGLE,
                          n_sph + n_quad), None

    idxs = jnp.arange(ng_ck.shape[0], dtype=jnp.int32)
    carry, _ = jax.lax.scan(
        tri_step, carry,
        (idxs, ng_ck, p0ng_ck, e1_ck, e2_ck, e2xp0_ck, p0xe1_ck, tv_ck))

    best_t, best_kind, best_idx, best_front, _ = carry
    return resolve_hit(scene, o, d, best_t, best_kind, best_idx, best_front,
                       t_min)


def resolve_hit(scene: SceneData, o, d, t, kind, idx, front,
                t_min: float) -> HitRecord:
    """Compute position/normal/material for the winning primitive only
    (cheap per-ray gathers instead of (R,K,3) attribute math)."""
    hit = kind >= 0
    t_safe = jnp.where(hit, t, 0.0)
    pos = o + t_safe[:, None] * d

    # Sphere attributes
    s_idx = jnp.clip(idx, 0, scene.sph_center.shape[0] - 1)
    s_center = scene.sph_center[s_idx]
    s_normal = pos - s_center
    s_normal = s_normal / jnp.maximum(
        jnp.linalg.norm(s_normal, axis=1, keepdims=True), 1e-30)
    s_normal = jnp.where(front[:, None], s_normal, -s_normal)
    s_mat = scene.sph_mat[s_idx]

    # Quad attributes
    q_idx = jnp.clip(idx, 0, scene.quad_normal.shape[0] - 1)
    q_n = scene.quad_normal[q_idx]
    q_normal = jnp.where(front[:, None], q_n, -q_n)
    q_mat = scene.quad_mat[q_idx]

    # Triangle attributes: recompute barycentrics for the winner.
    t_idx = jnp.clip(idx, 0, scene.tri_v0.shape[0] - 1)
    v0 = scene.tri_v0[t_idx]
    v1 = scene.tri_v1[t_idx]
    v2 = scene.tri_v2[t_idx]
    e1 = v1 - v0
    e2 = v2 - v0
    s = o - v0
    s1 = jnp.cross(d, e2)
    s2 = jnp.cross(s, e1)
    div = jnp.sum(s1 * e1, axis=1)
    div = jnp.where(div == 0.0, 1.0, div)
    b1 = jnp.sum(s1 * s, axis=1) / div
    b2 = jnp.sum(s2 * d, axis=1) / div
    b0 = 1.0 - b1 - b2
    tn = (b0[:, None] * scene.tri_n0[t_idx]
          + b1[:, None] * scene.tri_n1[t_idx]
          + b2[:, None] * scene.tri_n2[t_idx])
    tri_back = jnp.sum(tn * d, axis=1) > 0.0  # shape.h:294-302 flip
    tn = jnp.where(tri_back[:, None], -tn, tn)
    tn = tn / jnp.maximum(jnp.linalg.norm(tn, axis=1, keepdims=True), 1e-30)
    t_mat = scene.tri_mat[t_idx]

    is_s = kind == KIND_SPHERE
    is_q = kind == KIND_QUAD
    is_t = kind == KIND_TRIANGLE

    normal = jnp.where(is_s[:, None], s_normal,
                       jnp.where(is_q[:, None], q_normal, tn))
    mat = jnp.where(is_s, s_mat, jnp.where(is_q, q_mat, t_mat))
    front = jnp.where(is_t, ~tri_back, front)

    uv = None
    if scene.tex_atlas is not None:
        # Surface UVs, computed only on image-textured scenes.
        # Sphere: equirectangular map of the OUTWARD unit normal.
        out_n = pos - s_center
        out_n = out_n / jnp.maximum(
            jnp.linalg.norm(out_n, axis=1, keepdims=True), 1e-30)
        s_u = 0.5 + jnp.arctan2(out_n[:, 2], out_n[:, 0]) / (2.0 * jnp.pi)
        s_v = 0.5 - jnp.arcsin(jnp.clip(out_n[:, 1], -1.0, 1.0)) / jnp.pi
        # Quad: half-extent coordinates (a, b) in [-1,1] -> [0,1].
        qu = scene.quad_u[q_idx]
        qv = scene.quad_v[q_idx]
        qc = scene.quad_center[q_idx]
        rel = pos - qc
        q_u = 0.5 + 0.5 * (jnp.sum(rel * qu, axis=1)
                           / jnp.maximum(jnp.sum(qu * qu, axis=1), 1e-30))
        q_v = 0.5 + 0.5 * (jnp.sum(rel * qv, axis=1)
                           / jnp.maximum(jnp.sum(qv * qv, axis=1), 1e-30))
        # Triangle: barycentric blend of the vertex texcoords.
        t_uv = (b0[:, None] * scene.tri_uv0[t_idx]
                + b1[:, None] * scene.tri_uv1[t_idx]
                + b2[:, None] * scene.tri_uv2[t_idx])
        uv = jnp.where(is_s[:, None], jnp.stack([s_u, s_v], axis=1),
                       jnp.where(is_q[:, None],
                                 jnp.stack([q_u, q_v], axis=1), t_uv))

    return HitRecord(
        t=jnp.where(hit, t, jnp.inf),
        hit=hit,
        pos=pos,
        normal=jnp.where(hit[:, None], normal, 0.0),
        front=front & hit,
        mat=jnp.where(hit, mat, 0).astype(jnp.int32),
        kind=kind,
        idx=idx,
        uv=uv,
    )
