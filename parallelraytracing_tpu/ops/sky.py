"""Sky radiance models (extension — the reference hardcodes one constant
sky in four places: /root/reference/src/backend/cpu/renderer.h:31,
cuda_megakernel/renderer.cu:159, cuda_wavefront/renderer.cu:404,
optix/renderer.cpp:41-43).

Three compositional models, selected by the SceneData pytree STRUCTURE
(None fields compile away, so reference scenes keep the exact constant
path):

- constant: `sky` alone (the reference behavior).
- gradient: lerp(sky, sky_top, 0.5*(d_hat.y + 1)) — the RTiOW sky.
- sun: + sun_color * max(dot(d_hat, sun_dir), 0)^power.

Directions from the BSDFs are NOT unit length (Lambertian scatter is
normal + unit vector, material.h:11-41), so d is normalized here; the
trace kernel (ops/trace_kernel.py miss block) implements the identical
math with a static spec so every engine agrees bit-for-bit on shared
streams (tests/test_sky.py).
"""

from __future__ import annotations

import jax.numpy as jnp


def sky_radiance(scene, d: jnp.ndarray) -> jnp.ndarray:
    """Per-ray escape radiance for (n,3) directions -> (n,3).

    scene: SceneData (fields sky, sky_top, sun).  With sky_top and sun
    both None this broadcasts the constant and adds zero ops."""
    if scene.sky_top is None and scene.sun is None:
        return jnp.broadcast_to(scene.sky, d.shape)
    inv_len = jnp.float32(1.0) / jnp.sqrt(jnp.sum(d * d, axis=-1))
    if scene.sky_top is not None:
        t = 0.5 * (d[:, 1] * inv_len + 1.0)
        base = scene.sky[None, :] + t[:, None] * (scene.sky_top
                                                  - scene.sky)[None, :]
    else:
        base = jnp.broadcast_to(scene.sky, d.shape)
    if scene.sun is not None:
        sd, sc, power = scene.sun[0:3], scene.sun[3:6], scene.sun[6]
        cosang = jnp.maximum(jnp.sum(d * sd[None, :], axis=-1) * inv_len,
                             0.0)
        w = jnp.power(cosang, power)
        base = base + w[:, None] * sc[None, :]
    return base
