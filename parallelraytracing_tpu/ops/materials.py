"""Branchless BSDF evaluation over the material table.

Replaces the reference's tagged-pointer dispatch
(/root/reference/src/core/tagged_pointer.h:10-117,
material.h:139-161): all four BSDFs are evaluated masked and the result
selected by material type code — they are a handful of elementwise ops
each, far cheaper than serializing `lax.switch` branches.

BSDF semantics are faithful replicas of material.h:
- Lambertian (11-41): scatter dir = normal + random unit vector, with the
  near-zero degenerate guard falling back to the normal.
- Metal (43-69): mirror reflection + roughness * random unit vector; the
  path dies if the scattered dir falls below the hemisphere.
- Dielectric (71-112): Snell with Schlick Fresnel (105-109), stochastic
  reflect/refract, attenuation = 1; refraction formula from math.h:45-50.
- Emissive (114-132): emits color, kills the path (Scatter -> false).

Randomness is counter-based (threefry): a (R,3) standard normal (normalized
-> exactly uniform on the sphere, replacing the reference's rejection loop
math.h:25-36, which is jit-hostile) and one (R,) uniform for the dielectric
reflect/refract choice.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.core.scene import (
    MAT_DIELECTRIC, MAT_EMISSIVE, MAT_LAMBERTIAN, MAT_METAL, SceneData)
from parallelraytracing_tpu.ops.intersect import HitRecord


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v, eps=1e-30):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def reflect(d, n):
    """Mirror reflection (glm::reflect): d - 2*dot(d,n)*n."""
    return d - 2.0 * _dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Snell refraction, reference math.h:45-50 (named `Reflect` there)."""
    cos_theta = jnp.minimum(_dot(-d, n), 1.0)
    r_perp = eta[..., None] * (d + cos_theta[..., None] * n)
    r_par = -jnp.sqrt(jnp.abs(1.0 - _dot(r_perp, r_perp)))[..., None] * n
    return r_perp + r_par


def schlick(cosine, ref_idx):
    """Schlick Fresnel approximation (material.h:105-109)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)


def random_unit_vectors(key: jax.Array, n: int) -> jax.Array:
    """(n,3) uniform directions via normalized gaussians — the analytic
    equivalent of the reference's rejection sampler (math.h:25-36)."""
    g = jax.random.normal(key, (n, 3), dtype=jnp.float32)
    return _normalize(g)


def surface_albedo(scene: SceneData, hit: HitRecord) -> jax.Array:
    """(R,3) albedo at the hit: the material table color, textured where
    the material carries a texture (ops/textures.py — checker from the
    world-space position, image from HitRecord.uv).  The single albedo
    source for the BSDF scatter AND the NEE direct term, so textures
    cannot drift between the two estimators."""
    albedo = scene.mat_albedo[hit.mat]
    if scene.mat_tex is not None:
        from parallelraytracing_tpu.ops.textures import textured_albedo
        albedo = textured_albedo(scene, hit, albedo)
    return albedo


def emitted(scene: SceneData, mat: jax.Array) -> jax.Array:
    """MaterialHandle::Emit (material.h:139-148): emissive color or zero."""
    mtype = scene.mat_type[mat]
    e = scene.mat_emit[mat]
    return jnp.where((mtype == MAT_EMISSIVE)[:, None], e, 0.0)


def scatter(
    scene: SceneData,
    d: jax.Array,            # (R,3) incoming unit directions
    hit: HitRecord,
    unit_vec: jax.Array,     # (R,3) random unit vectors
    uniform: jax.Array,      # (R,) uniforms in [0,1)
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Branchless MaterialHandle::Scatter (material.h:150-161).

    Returns (out_dir (R,3) unit, attenuation (R,3), alive (R,) bool).
    Scatter origins are hit.pos; the framework relies on ray tMin instead of
    origin offsets, like the reference."""
    n = hit.normal
    mtype = scene.mat_type[hit.mat]
    albedo = surface_albedo(scene, hit)
    rough = scene.mat_rough[hit.mat]
    ior = scene.mat_ior[hit.mat]

    # --- Lambertian (material.h:16-31)
    lam_dir = n + unit_vec
    degen = jnp.all(jnp.abs(lam_dir) < 1e-8, axis=-1)
    lam_dir = jnp.where(degen[:, None], n, lam_dir)
    lam_dir = _normalize(lam_dir)

    # --- Metal (material.h:48-57)
    refl = reflect(d, n)  # d unit => refl unit; reference normalizes anyway
    met_dir = _normalize(refl) + rough[:, None] * unit_vec
    met_dir = _normalize(met_dir)
    met_alive = _dot(met_dir, n) > 0.0

    # --- Dielectric (material.h:76-95)
    ri = jnp.where(hit.front, 1.0 / ior, ior)
    cos_theta = jnp.minimum(_dot(-d, n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri * sin_theta > 1.0
    reflect_choice = cannot_refract | (schlick(cos_theta, ri) > uniform)
    die_dir = jnp.where(reflect_choice[:, None],
                        reflect(d, n), refract(d, n, ri))
    die_dir = _normalize(die_dir)  # renderer normalizes scattered rays
    # (cuda_megakernel/renderer.cu:115, cuda_wavefront/renderer.cu:328)

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    is_emit = mtype == MAT_EMISSIVE

    out_dir = jnp.where(is_lam[:, None], lam_dir,
                        jnp.where(is_met[:, None], met_dir,
                                  jnp.where(is_die[:, None], die_dir, n)))
    attenuation = jnp.where(is_die[:, None], 1.0,
                            jnp.where(is_emit[:, None], 0.0, albedo))
    alive = jnp.where(is_met, met_alive, ~is_emit)
    return out_dir, attenuation, alive
