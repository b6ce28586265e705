"""Texture evaluation: 3D checker (procedural) + UV image sampling.

An extension over the reference, which loads mesh texcoords but never
samples them (/root/reference/src/core/mesh.cpp:84-104 reads "u","v";
no material in material.h consumes a texture).  Two kinds:

- the CHECKER is position-based (floor-parity of the world-space hit
  point): a handful of elementwise ops, no gathers;
- IMAGE textures are per-lane bilinear gathers from an atlas (the trace
  kernel fetches the four texels of each lane from its texel table).

Texture codes in SceneData.mat_tex: 0 = none, 1 = checker
(mat_tex_param = [cell scale, odd rgb]), >= 2 = image id (tex - 2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TEX_NONE = 0
TEX_CHECKER = 1
TEX_IMAGE_BASE = 2


#: lattice offset (1/pi): cell boundaries land at (k - 0.3183)/scale,
#: so axis-aligned surfaces at common coordinates (y=0 floors, integer
#: walls) sit MID-cell instead of exactly on a boundary — on a boundary
#: the hit point's float jitter flips floor() per pixel and the checker
#: aliases into noise (observed on the texture_demo floor).  The same
#: constant is baked into the trace kernel's checker (ops/trace_kernel).
CHECKER_OFFSET = 0.3183098861


def checker_weight(pos: jax.Array, scale: jax.Array) -> jax.Array:
    """(R,) in {0,1}: parity of the world-space checker cell at pos.

    floor-parity (not the RTIOW sin product) — three floors + adds beat
    three transcendentals, and cells are exact cubes of edge
    1/scale."""
    c = jnp.floor(pos * scale[:, None] + CHECKER_OFFSET)
    return jnp.abs(jnp.mod(c[:, 0] + c[:, 1] + c[:, 2], 2.0))


def sample_atlas(atlas: jax.Array, size: jax.Array, tex_id: jax.Array,
                 uv: jax.Array) -> jax.Array:
    """Bilinear, repeat-wrapped sample of atlas[tex_id] at uv.

    atlas (T,TH,TW,3) zero-padded; size (T,2) true (h,w); tex_id (R,) i32;
    uv (R,2) with v up (image row 0 = v=1, the PLY/OBJ convention).
    Returns (R,3)."""
    h = size[tex_id, 0].astype(jnp.float32)
    w = size[tex_id, 1].astype(jnp.float32)
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def fetch(yi, xi):
        # repeat-wrap into the texture's true extent, then gather.
        yi = jnp.mod(yi, h).astype(jnp.int32)
        xi = jnp.mod(xi, w).astype(jnp.int32)
        return atlas[tex_id, yi, xi]

    c00 = fetch(y0, x0)
    c01 = fetch(y0, x0 + 1.0)
    c10 = fetch(y0 + 1.0, x0)
    c11 = fetch(y0 + 1.0, x0 + 1.0)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def textured_albedo(scene, hit, albedo: jax.Array) -> jax.Array:
    """Replace albedo where the hit material carries a texture.

    scene: SceneData with mat_tex set; hit: HitRecord (pos always; uv
    required only when the scene has image textures — HitRecord.uv is
    populated by resolve_hit exactly then)."""
    tex = scene.mat_tex[hit.mat]
    param = scene.mat_tex_param[hit.mat]

    is_check = tex == TEX_CHECKER
    wgt = checker_weight(hit.pos, param[:, 0])
    odd = param[:, 1:4]
    albedo = jnp.where((is_check & (wgt > 0.5))[:, None], odd, albedo)

    if scene.tex_atlas is not None:
        is_img = tex >= TEX_IMAGE_BASE
        tid = jnp.clip(tex - TEX_IMAGE_BASE, 0,
                       scene.tex_atlas.shape[0] - 1)
        img = sample_atlas(scene.tex_atlas, scene.tex_size, tid, hit.uv)
        albedo = jnp.where(is_img[:, None], img * albedo, albedo)
    return albedo
