"""LBVH construction: Morton codes -> Karras binary radix tree -> threaded
(stackless) layout.

The JAX replacement for the reference's OptiX acceleration
structures (GAS/IAS builds, optix/renderer.cpp:703-871): where OptiX hides
the BVH behind `optixAccelBuild` + RT cores, we build a linear BVH over ALL
primitives (spheres, quads, triangles in one tree — the reference builds
two custom-primitive GASes wrapped in an IAS) and flatten it into a
threaded depth-first layout so traversal needs NO stack:

    node = 0
    while node != -1:
        if AABB hit:  node = node+1 (preorder child)  [or intersect leaf]
        else:         node = miss_link[node]          (escape the subtree)

which is the per-lane control flow a vectorized (8x128-lane) traversal
loop can actually run.  Construction is host-side numpy at scene-compile
time (topology is static in the reference too — built once at Init,
renderer.cpp:703, never refit); per-frame refit hooks land with animated
scenes.

Quad leaf AABBs are padded +-0.01 exactly like the reference's quad GAS
(optix/renderer.cpp:768-831).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu.core import geometry as geo
from parallelraytracing_tpu.core.scene import (
    KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, SceneData)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHData:
    """Threaded BVH in preorder. M = 2*N-1 nodes (N = primitive count);
    a hit continues to node+1, a miss jumps to node_miss (-1 = done)."""

    node_min: jax.Array   # (M,3) f32
    node_max: jax.Array   # (M,3) f32
    node_kind: jax.Array  # (M,) i32: KIND_* for leaves, -1 for internal
    node_idx: jax.Array   # (M,) i32: index into the kind's SoA table
    node_miss: jax.Array  # (M,) i32: escape link, -1 terminates
    node_ord: jax.Array   # (M,) i32: global primitive ordinal (tie-break)

    @property
    def num_nodes(self) -> int:
        return int(self.node_miss.shape[0])


# ----------------------------------------------------------------- morton

def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v over 30 bits (x -> x<<2 interleave)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """(N,3) in [0,1] -> (N,) uint64 30-bit Morton codes."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) \
        | _expand_bits(q[:, 2])


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64 (vectorized, exact)."""
    x = x.astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v):
        v = v.astype(np.int64)
        bl = np.zeros_like(v)
        nz = v > 0
        bl[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
        return 32 - bl

    out = np.where(hi > 0, clz32(hi), 32 + clz32(lo))
    return out.astype(np.int64)


# ------------------------------------------------------------ karras tree

def _karras_tree(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Binary radix tree over sorted unique 64-bit keys.

    Returns (left, right): children of the N-1 internal nodes; child c
    encodes an internal node as c and a leaf as ~c (bitwise not)."""
    n = len(keys)
    if n == 1:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    i = np.arange(n - 1, dtype=np.int64)

    def delta(a, b):
        """Common-prefix length of keys[a], keys[b]; -1 out of range."""
        ok = (b >= 0) & (b < n)
        bb = np.clip(b, 0, n - 1)
        d = _clz64(keys[a] ^ keys[bb])
        return np.where(ok, d, -1)

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential search for the range's other end.
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = delta(i, i + lmax * d) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if (lmax > 4 * n).all():
            break

    # Binary search the exact length l.
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t > 0).any():
        cand = i + (l + t) * d
        ok = (t > 0) & (delta(i, cand) > delta_min)
        l = np.where(ok, l + t, l)
        t //= 2
    j = i + l * d

    # Binary search the split position (highest differing bit in range).
    delta_node = delta(i, j)
    s = np.zeros(n - 1, np.int64)
    t = np.int64(1)
    # ceil(l/2), ceil(l/4), ...
    div = np.ones(n - 1, np.int64)
    while True:
        div *= 2
        t = (l + div - 1) // div
        cand = i + (s + t) * d
        ok = (t >= 1) & (delta(i, cand) > delta_node)
        s = np.where(ok, s + t, s)
        if (t <= 1).all():
            break
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = np.where(lo == gamma, ~gamma, gamma)            # leaf if range==1
    right = np.where(hi == gamma + 1, ~(gamma + 1), gamma + 1)
    return left, right


# ---------------------------------------------------------------- threading

def _subtree_sizes(left: np.ndarray, right: np.ndarray, n_leaves: int):
    """Size (node count) of each internal node's subtree, bottom-up."""
    n_int = n_leaves - 1
    size = np.ones(n_int, np.int64) * -1

    # iterative postorder
    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        lc, rc = left[node], right[node]
        lsz = 1 if lc < 0 else size[lc]
        rsz = 1 if rc < 0 else size[rc]
        if processed or (lsz > 0 and rsz > 0):
            size[node] = 1 + lsz + rsz
        else:
            stack.append((node, True))
            if lc >= 0 and size[lc] < 0:
                stack.append((lc, False))
            if rc >= 0 and size[rc] < 0:
                stack.append((rc, False))
    return size


def thread_tree(left: np.ndarray, right: np.ndarray, n_leaves: int):
    """Preorder + escape links, computed with explicit subtree sizes.

    Returns (is_leaf (M,), payload (M,), miss (M,)) where payload is the
    sorted-leaf index for leaves and the internal-node id otherwise."""
    if n_leaves == 1:
        return (np.array([True]), np.array([0], np.int64),
                np.array([-1], np.int64))
    size = _subtree_sizes(left, right, n_leaves)
    m = 2 * n_leaves - 1
    is_leaf = np.zeros(m, bool)
    payload = np.zeros(m, np.int64)
    miss = np.full(m, -1, np.int64)

    stack = [(0, False, -1)]
    out = 0
    while stack:
        code, leaf, escape = stack.pop()
        idx = out
        out += 1
        is_leaf[idx] = leaf
        payload[idx] = code
        miss[idx] = escape
        if not leaf:
            lc, rc = left[code], right[code]
            l_leaf = lc < 0
            r_leaf = rc < 0
            l_code = ~lc if l_leaf else lc
            r_code = ~rc if r_leaf else rc
            l_size = 1 if l_leaf else size[l_code]
            right_slot = idx + 1 + l_size
            stack.append((r_code, bool(r_leaf), escape))
            stack.append((l_code, bool(l_leaf), right_slot))
    assert out == m
    return is_leaf, payload, miss


# ------------------------------------------------------------------- build

def scene_primitive_aabbs(scene: SceneData):
    """World AABBs + kind/idx of every valid primitive (numpy)."""
    mins, maxs, kinds, idxs = [], [], [], []

    sv = np.asarray(scene.sph_valid)
    if sv.any():
        c = np.asarray(scene.sph_center, np.float64)[sv]
        r = np.asarray(scene.sph_radius, np.float64)[sv]
        mn, mx = geo.sphere_aabb(c, r)
        mins.append(mn); maxs.append(mx)
        kinds.append(np.full(len(r), KIND_SPHERE))
        idxs.append(np.nonzero(sv)[0])

    qv = np.asarray(scene.quad_valid)
    if qv.any():
        c = np.asarray(scene.quad_center, np.float64)[qv]
        u = np.asarray(scene.quad_u, np.float64)[qv]
        v = np.asarray(scene.quad_v, np.float64)[qv]
        mn, mx = geo.quad_aabb(c, u, v)
        mins.append(mn); maxs.append(mx)
        kinds.append(np.full(len(c), KIND_QUAD))
        idxs.append(np.nonzero(qv)[0])

    tv = np.asarray(scene.tri_valid)
    if tv.any():
        v0 = np.asarray(scene.tri_v0, np.float64)[tv]
        v1 = np.asarray(scene.tri_v1, np.float64)[tv]
        v2 = np.asarray(scene.tri_v2, np.float64)[tv]
        mn, mx = geo.triangle_aabb(v0, v1, v2)
        mins.append(mn); maxs.append(mx)
        kinds.append(np.full(len(v0), KIND_TRIANGLE))
        idxs.append(np.nonzero(tv)[0])

    if not mins:
        return (np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    return (np.concatenate(mins), np.concatenate(maxs),
            np.concatenate(kinds), np.concatenate(idxs))


def build_threaded(mn: np.ndarray, mx: np.ndarray):
    """Generic threaded LBVH over N AABBs (host numpy).

    Returns (node_min (M,3), node_max (M,3), is_leaf (M,), payload (M,),
    miss (M,)) with M = 2N-1 (M=1 for N=1); for leaves, payload is the
    ORIGINAL primitive index (sorted-leaf order already resolved).  Uses
    the native builder when available.  This is the mesh-agnostic core
    shared by the scene BVH and the TLAS/BLAS builders."""
    n = len(mn)
    assert n >= 1
    if n == 1:
        return (mn.copy(), mx.copy(), np.array([True]),
                np.array([0], np.int64), np.array([-1], np.int64))
    try:
        from parallelraytracing_tpu import native
        if native.available():
            node_min, node_max, is_leaf, payload, miss, order = \
                native.build_lbvh(mn.astype(np.float64),
                                  mx.astype(np.float64))
            payload = payload.astype(np.int64)
            payload[is_leaf] = order[payload[is_leaf]]
            return (node_min, node_max, is_leaf, payload,
                    miss.astype(np.int64))
    except Exception:
        pass

    centroid = (mn + mx) * 0.5
    lo = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable")
    keys = (codes[order].astype(np.uint64) << np.uint64(31)) \
        | np.arange(n, dtype=np.uint64)
    left, right = _karras_tree(keys)
    is_leaf, payload, miss = thread_tree(left, right, n)
    m = 2 * n - 1
    node_min = np.zeros((m, 3))
    node_max = np.zeros((m, 3))
    leaf_slots = np.nonzero(is_leaf)[0]
    src = order[payload[leaf_slots]]
    payload = payload.copy()
    payload[leaf_slots] = src
    node_min[leaf_slots] = mn[src]
    node_max[leaf_slots] = mx[src]
    stack = []
    for s in range(m - 1, -1, -1):
        if is_leaf[s]:
            stack.append((node_min[s].copy(), node_max[s].copy()))
        else:
            mn1, mx1 = stack.pop()
            mn2, mx2 = stack.pop()
            node_min[s] = np.minimum(mn1, mn2)
            node_max[s] = np.maximum(mx1, mx2)
            stack.append((node_min[s], node_max[s]))
    assert len(stack) == 1
    return node_min, node_max, is_leaf, payload, miss


def _global_ordinals(scene: SceneData, kind: np.ndarray,
                     idx: np.ndarray) -> np.ndarray:
    """Global primitive ordinal = kind offset + within-kind index (spheres,
    quads, triangles) — the tie-break convention shared with
    ops/intersect.py's scan order and ops/trace_kernel.py's ord columns, so
    coplanar equal-t hits resolve identically on every path."""
    n_sph = int(np.asarray(scene.sph_valid).shape[0])
    n_quad = int(np.asarray(scene.quad_valid).shape[0])
    off = np.where(kind == KIND_SPHERE, 0,
                   np.where(kind == KIND_QUAD, n_sph, n_sph + n_quad))
    return off + idx


def build_bvh(scene: SceneData, dtype=jnp.float32,
              prefer_native: bool = True) -> BVHData:
    """Build the threaded LBVH for a compiled scene.

    Uses the native C++ builder when available (native/src/lbvh.cpp —
    bit-identical topology, ~100x faster on large meshes); the Python path
    below is the reference implementation and fallback."""
    mn, mx, kind, idx = scene_primitive_aabbs(scene)
    if prefer_native and len(kind) > 1:
        try:
            from parallelraytracing_tpu import native
            if native.available():
                return _assemble_bvh_native(scene, mn, mx, kind, idx, dtype)
        except Exception:
            pass
    return _build_bvh_python(scene, mn, mx, kind, idx, dtype)


def _assemble_bvh_native(scene, mn, mx, kind, idx, dtype) -> BVHData:
    from parallelraytracing_tpu import native
    node_min, node_max, is_leaf, payload, miss, order = native.build_lbvh(mn, mx)
    m = len(miss)
    node_kind = np.full(m, -1, np.int64)
    node_idx = np.zeros(m, np.int64)
    node_ord = np.zeros(m, np.int64)
    leaf_slots = np.nonzero(is_leaf)[0]
    src = order[payload[leaf_slots]]
    node_kind[leaf_slots] = kind[src]
    node_idx[leaf_slots] = idx[src]
    node_ord[leaf_slots] = _global_ordinals(scene, kind[src], idx[src])
    return BVHData(
        node_min=jnp.asarray(node_min, dtype),
        node_max=jnp.asarray(node_max, dtype),
        node_kind=jnp.asarray(node_kind, jnp.int32),
        node_idx=jnp.asarray(node_idx, jnp.int32),
        node_miss=jnp.asarray(miss, jnp.int32),
        node_ord=jnp.asarray(node_ord, jnp.int32))


def _build_bvh_python(scene: SceneData, mn, mx, kind, idx,
                      dtype=jnp.float32) -> BVHData:
    n = len(kind)
    if n == 0:
        return BVHData(
            node_min=jnp.zeros((1, 3), dtype),
            node_max=jnp.full((1, 3), -1.0, dtype),
            node_kind=jnp.full((1,), -1, jnp.int32),
            node_idx=jnp.zeros((1,), jnp.int32),
            node_miss=jnp.full((1,), -1, jnp.int32),
            node_ord=jnp.zeros((1,), jnp.int32))

    centroid = (mn + mx) * 0.5
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)
    # Unique keys: append the primitive rank in the low bits (Karras
    # requires distinct keys).
    order = np.argsort(codes, kind="stable")
    keys = (codes[order].astype(np.uint64) << np.uint64(31)) \
        | np.arange(n, dtype=np.uint64)

    left, right = _karras_tree(keys)
    is_leaf, payload, miss = thread_tree(left, right, n)

    m = 2 * n - 1
    node_min = np.zeros((m, 3))
    node_max = np.zeros((m, 3))
    node_kind = np.full(m, -1, np.int64)
    node_idx = np.zeros(m, np.int64)
    node_ord = np.zeros(m, np.int64)

    # Leaves: payload is the index into the SORTED order.
    leaf_slots = np.nonzero(is_leaf)[0]
    src = order[payload[leaf_slots]]
    node_min[leaf_slots] = mn[src]
    node_max[leaf_slots] = mx[src]
    node_kind[leaf_slots] = kind[src]
    node_idx[leaf_slots] = idx[src]
    # Global ordinal (kind offset + within-kind index): ties at identical t
    # (e.g. coplanar overlapping quads — Cornell's light overlaps its walls)
    # resolve to the lowest ordinal, matching the strict-< first-wins loops
    # of the reference (primitive.cpp:42-48,
    # cuda_megakernel/renderer.cu:59-67) and our brute-force fold.
    node_ord[leaf_slots] = _global_ordinals(scene, kind[src], idx[src])

    # Internal AABBs: preorder guarantees children come after parents, so a
    # reverse sweep unioning each node into its parent works; we instead
    # union over preorder ranges: parent at slot i covers slots
    # [i+1, miss_target) — equivalently accumulate in reverse with a stack.
    # Simple exact approach: reverse preorder, keep a stack of (slot, aabb).
    stack = []
    for s in range(m - 1, -1, -1):
        if is_leaf[s]:
            stack.append((s, node_min[s].copy(), node_max[s].copy()))
        else:
            (s1, mn1, mx1) = stack.pop()
            (s2, mn2, mx2) = stack.pop()
            node_min[s] = np.minimum(mn1, mn2)
            node_max[s] = np.maximum(mx1, mx2)
            stack.append((s, node_min[s], node_max[s]))
    assert len(stack) == 1

    return BVHData(
        node_min=jnp.asarray(node_min, dtype),
        node_max=jnp.asarray(node_max, dtype),
        node_kind=jnp.asarray(node_kind, jnp.int32),
        node_idx=jnp.asarray(node_idx, jnp.int32),
        node_miss=jnp.asarray(miss, jnp.int32),
        node_ord=jnp.asarray(node_ord, jnp.int32))
