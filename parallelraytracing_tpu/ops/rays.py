"""Device-side camera ray generation.

Vectorized replica of Camera::GetCameraRay
(/root/reference/src/core/camera.h:104-132): pinhole with vertical FoV of
1 radian (tanFovY = tan(0.5)), Y-flipped NDC, looking down -Z, world dir
= x*right + y*up + z*(-front).  Optional sub-pixel jitter reproduces the
OptiX backend's anti-aliasing (device_programs.cu:172-173); the other
reference backends sample pixel centers (+0.5).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

TAN_FOVY = math.tan(0.5)


def _norm(v: jax.Array, axis: int = -1) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def generate_camera_rays(
    cam_params: jax.Array,
    width: int,
    height: int,
    key: jax.Array | None = None,
    jitter: bool = True,
    lens=None,
    pix_seed: jax.Array | None = None,
    qpt: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (origins, directions), each (H*W, 3) f32, row-major like the
    reference film (pixel index = y*W + x, film.h:48-49).

    cam_params: packed [position(3), right(3), up(3), front(3), w, h]
    (Camera.ray_params()).

    pix_seed / qpt: pixel-keyed (optionally QMC-rotated) sampling, same
    contract as generate_camera_rays_ids — the jnp engines use this for
    cfg.qmc."""
    pos = cam_params[0:3]
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]

    y = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    x = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)

    idx = None
    if pix_seed is not None:
        iy = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        idx = iy * width + ix

    if jitter and pix_seed is not None:
        jx, jy = pixel_keyed_jitter(idx, pix_seed)
        if qpt is not None:
            jx, jy = _rot(jx, qpt[0]), _rot(jy, qpt[1])
        px = x + jx
        py = y + jy
    elif jitter and key is not None:
        jx, jy = jax.random.uniform(key, (2, height, width), dtype=jnp.float32)
        px = x + jx
        py = y + jy
    else:
        px = x + 0.5
        py = y + 0.5

    ndc_x = (px / width) * 2.0 - 1.0
    ndc_y = 1.0 - (py / height) * 2.0
    aspect = width / height

    dx = ndc_x * (aspect * TAN_FOVY)
    dy = ndc_y * TAN_FOVY
    dz = -jnp.ones_like(dx)

    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    # World direction: x*right + y*up + (-1)*(-front) = x*right + y*up + front
    d = (dx[..., None] * right + dy[..., None] * up + dz[..., None] * (-front))
    d = _norm(d)

    o = jnp.broadcast_to(pos, d.shape)
    n = height * width
    o, d = o.reshape(n, 3), d.reshape(n, 3)
    if lens is not None and lens[0] > 0.0:
        if pix_seed is not None:
            flat = idx.reshape(-1)
            u1 = _pixel_u01(flat, pix_seed, 103)
            u2 = _pixel_u01(flat, pix_seed, 104)
            if qpt is not None:
                u1, u2 = _rot(u1, qpt[2]), _rot(u2, qpt[3])
        elif key is not None:
            u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 2),
                                   dtype=jnp.float32)
            u1, u2 = u[:, 0], u[:, 1]
        else:  # deterministic callers: sample the lens center (pinhole)
            u1 = u2 = jnp.zeros((n,), jnp.float32)
        o, d = apply_thin_lens(o, d, cam_params, lens, u1, u2)
    return o, d


def generate_camera_rays_flat(
    cam_params: jax.Array,
    width: int,
    height: int,
    start: jax.Array | int,
    count: int,
    key: jax.Array | None = None,
    jitter: bool = True,
    lens=None,
    pix_seed: jax.Array | None = None,
    qpt: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Rays for the flat pixel-index range [start, start+count) — the
    primitive for sharded/tiled raygen where each device or tile generates
    only its own block (indices past H*W produce harmless dummy rays)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, (count, 1), 0)[:, 0] + start
    return generate_camera_rays_ids(cam_params, width, height, idx, key,
                                    jitter, lens=lens, pix_seed=pix_seed,
                                    qpt=qpt)


def radical_inverse(i: int, base: int) -> float:
    """Van der Corput radical inverse of integer i in the given base —
    host-side (the per-sample Halton point is a frame-loop scalar, never
    traced)."""
    f, inv, r = 1.0 / base, 1.0 / base, 0.0
    while i > 0:
        r += (i % base) * f
        i //= base
        f *= inv
    return r


def halton_qpt(g: int):
    """The 4D Halton point for global sample index g, as a host (4,) f32:
    bases (2,3) drive the sub-pixel jitter and (5,7) the thin-lens
    aperture.  QMC sampling is an extension — every reference backend is
    plain MC (curand / PCG, SURVEY §3.6 RNG notes)."""
    import numpy as np
    return np.array([radical_inverse(g, 2), radical_inverse(g, 3),
                     radical_inverse(g, 5), radical_inverse(g, 7)],
                    np.float32)


def qmc_rotation_seed(seed: int) -> jax.Array:
    """The frame-INDEPENDENT pixel-keyed rotation seed for QMC sampling
    (u32 scalar).  Cranley–Patterson rotation: every pixel offsets the
    shared Halton point by its own fixed uniforms (salts 101-104), so
    pixels stay decorrelated while each pixel's sample sequence over
    frames is a rotated low-discrepancy sequence.  Shared derivation —
    fused / wavefront_fused / sharded must all use THIS seed or the
    engines' bit-identity contract breaks (see frame_stream_seeds)."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(0x514D43))
    return jax.random.randint(k, (), 0, 2**31 - 1,
                              jnp.int32).astype(jnp.uint32)


def _rot(u: jax.Array, off: jax.Array) -> jax.Array:
    """Cranley–Patterson rotation: (u + off) mod 1."""
    v = u + off
    return v - jnp.floor(v)


def frame_stream_seeds(skey: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """THE per-(frame, sample) seed derivation every kernel engine and
    instrument shares: split the sample key into the pixel-jitter seed
    (uint32 scalar, feeds pixel_keyed_jitter) and the in-kernel path
    seed (int32 scalar).  fused / wavefront_fused / sharded, bench.py's
    exact ray counter and benchmarks/trace_stats.py must all draw THESE
    streams — any site drifting by even the randint order breaks the
    engines' bit-identity contract and the "exact rays" Mrays/s
    numerator with no error raised, so the derivation lives here once."""
    k_jit, k_path = jax.random.split(skey)
    jseed = jax.random.randint(k_jit, (), 0, 2**31 - 1,
                               jnp.int32).astype(jnp.uint32)
    seed = jax.random.randint(k_path, (), 0, 2**31 - 1, jnp.int32)
    return jseed, seed


def _pixel_u01(idx: jax.Array, seed: jax.Array, salt: int) -> jax.Array:
    """[0,1) uniform from a stateless PCG hash of (pixel id, seed, salt) —
    the raygen-side twin of the in-kernel pixel-keyed streams.  Salts in
    use: 101/102 = sub-pixel jitter, 103/104 = thin-lens aperture."""
    from parallelraytracing_tpu.ops.trace_kernel import _pcg_hash
    base = idx.astype(jnp.uint32) ^ seed.astype(jnp.uint32)
    bits = _pcg_hash(base ^ jnp.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF))
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(1.0 / (1 << 24))


def pixel_keyed_jitter(idx: jax.Array, seed: jax.Array):
    """(jx, jy) in [0,1) from a stateless PCG hash of (pixel id, seed).

    Unlike threefry draws over a block (whose values depend on the
    block's size and the slot order), these depend only on the PIXEL and
    the frame seed — so sharded/permuted raygen produces the same jitter
    for a pixel regardless of which device traces it or how the shard
    blocks are laid out (the same layout-invariance contract the
    in-kernel pixel-keyed path RNG provides)."""
    return _pixel_u01(idx, seed, 101), _pixel_u01(idx, seed, 102)


def apply_thin_lens(o, d, cam_params, lens, u1, u2):
    """Thin-lens (defocus blur) transform of pinhole rays — an extension
    over the reference, whose cameras are all pinhole (camera.h:104-132).

    lens = (aperture_radius, focus_distance) in world units, static.  Each
    pinhole ray (o, d) is re-aimed at the point where it crosses the focal
    plane (perpendicular to `front` at focus_distance) from a new origin
    sampled on the lens disk; points ON the focal plane therefore stay
    sharp while everything else blurs in proportion to its defocus.
    (u1, u2) are per-ray uniforms in [0,1); o (R,3) or broadcastable,
    d (R,3) unit."""
    radius, fdist = lens
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]
    # Polar disk sample: area-uniform in r = R*sqrt(u1).
    r = radius * jnp.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    lx = r * jnp.cos(theta)
    ly = r * jnp.sin(theta)
    # Focal point of the pinhole ray (d is unit; d.front > 0 for camera
    # rays, so the plane crossing is always ahead).
    t_f = fdist / jnp.maximum(
        d[:, 0] * front[0] + d[:, 1] * front[1] + d[:, 2] * front[2], 1e-6)
    p = o + d * t_f[:, None]
    o2 = o + lx[:, None] * right + ly[:, None] * up
    return o2, _norm(p - o2)


def generate_camera_rays_ids(
    cam_params: jax.Array,
    width: int,
    height: int,
    idx: jax.Array,
    key: jax.Array | None = None,
    jitter: bool = True,
    pix_seed: jax.Array | None = None,
    lens=None,
    qpt: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Rays for an EXPLICIT flat pixel-id vector — the raygen primitive
    for permuted (e.g. Morton-ordered) shard blocks, where a device's
    pixels are not a contiguous range (ids past H*W produce harmless
    dummy rays).  With pix_seed (a u32 scalar), jitter is pixel-keyed
    (pixel_keyed_jitter) instead of threefry-block-keyed.

    lens = (aperture_radius, focus_distance) enables thin-lens defocus
    blur (apply_thin_lens); pixel-keyed callers draw the aperture sample
    from salts 103/104 so the blur — like the jitter — is invariant to
    shard layout and ray order.

    qpt (QMC mode, requires pix_seed): the (4,) f32 Halton point of this
    sample (halton_qpt).  The pixel-keyed draws become per-pixel
    Cranley–Patterson rotations of it — callers pass the
    frame-INDEPENDENT qmc_rotation_seed as pix_seed so each pixel's
    samples over frames form a rotated low-discrepancy sequence, while
    the layout-invariance contract is untouched (the rotation is still
    keyed on the pixel id alone)."""
    count = idx.shape[0]
    pos = cam_params[0:3]
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]

    x = (idx % width).astype(jnp.float32)
    y = (idx // width).astype(jnp.float32)

    if jitter and pix_seed is not None:
        jx, jy = pixel_keyed_jitter(idx, pix_seed)
        if qpt is not None:
            jx, jy = _rot(jx, qpt[0]), _rot(jy, qpt[1])
        px, py = x + jx, y + jy
    elif jitter and key is not None:
        j = jax.random.uniform(key, (count, 2), dtype=jnp.float32)
        px, py = x + j[:, 0], y + j[:, 1]
    else:
        px, py = x + 0.5, y + 0.5

    ndc_x = (px / width) * 2.0 - 1.0
    ndc_y = 1.0 - (py / height) * 2.0
    dx = ndc_x * (width / height * TAN_FOVY)
    dy = ndc_y * TAN_FOVY
    dz = -jnp.ones_like(dx)
    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    d = (dx[:, None] * right + dy[:, None] * up + dz[:, None] * (-front))
    d = _norm(d)
    o = jnp.broadcast_to(pos, d.shape)
    if lens is not None and lens[0] > 0.0:
        if pix_seed is not None:
            u1 = _pixel_u01(idx, pix_seed, 103)
            u2 = _pixel_u01(idx, pix_seed, 104)
            if qpt is not None:
                u1, u2 = _rot(u1, qpt[2]), _rot(u2, qpt[3])
        elif key is not None:
            u = jax.random.uniform(jax.random.fold_in(key, 1), (count, 2),
                                   dtype=jnp.float32)
            u1, u2 = u[:, 0], u[:, 1]
        else:
            u1 = u2 = jnp.zeros((count,), jnp.float32)
        o, d = apply_thin_lens(o, d, cam_params, lens, u1, u2)
    return o, d
