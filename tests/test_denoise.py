"""À-trous denoiser (postfx/denoise.py — extension; the reference
displays raw MC accumulation).

Load-bearing properties: guide buffers are noise-free and geometrically
sane; denoising a LOW-spp frame moves it strictly closer (MSE) to the
converged reference than the noisy input was; demodulation preserves
albedo detail (a checker floor keeps its transitions); the filter is
deterministic and jit-compiles once per (shape, iterations).
"""

import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import Camera, default_camera
from parallelraytracing_tpu.postfx import (atrous_denoise, aux_buffers,
                                           denoise_film)

import pytest

pytestmark = pytest.mark.slow  # 192-frame jnp truth renders

CFG = RenderConfig(width=64, height=64, max_depth=5, seed=7,
                   intersect_chunk=32, ray_tile=1 << 16)


def _film(scene, cam, cfg, frames, engine="megakernel"):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    r.init(film, scene, cam, cfg)
    for _ in range(frames):
        r.progressive_render()
    return film


def test_aux_buffers_geometry():
    scene = Scene(ScenePreset.CORNELL)
    cam = default_camera(64, 64)
    normal, albedo, depth = aux_buffers(scene.build(),
                                        jnp.asarray(cam.ray_params()), CFG)
    normal, albedo, depth = map(np.asarray, (normal, albedo, depth))
    hit = np.isfinite(depth)
    assert hit.mean() > 0.5  # cornell fills most of the frame
    lens = np.linalg.norm(normal[hit], axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)
    assert (depth[hit] > 0).all()
    # miss pixels carry the sky albedo
    if (~hit).any():
        sky = np.asarray(scene.build().sky)
        np.testing.assert_allclose(
            albedo[~hit], np.broadcast_to(sky, ((~hit).sum(), 3)),
            atol=1e-6)


def test_denoise_reduces_mse_to_converged():
    scene = Scene(ScenePreset.CORNELL)
    cam = default_camera(64, 64)
    ref = np.asarray(_film(scene, cam, CFG, 192).hdr_average()) \
        .reshape(64, 64, 3)
    noisy_film = _film(scene, cam, CFG.replace(seed=123), 4)
    noisy = np.asarray(noisy_film.hdr_average()).reshape(64, 64, 3)
    den = np.asarray(denoise_film(noisy_film, scene.build(),
                                  jnp.asarray(cam.ray_params()), CFG,
                                  iterations=4))
    mse_noisy = float(((noisy - ref) ** 2).mean())
    mse_den = float(((den - ref) ** 2).mean())
    assert mse_den < 0.15 * mse_noisy, (mse_noisy, mse_den)
    # ...and a converged input is NOT damaged: filtering the reference
    # itself deviates far less than the noise it removes.
    ref_den = np.asarray(atrous_denoise(
        jnp.asarray(ref),
        *aux_buffers(scene.build(), jnp.asarray(cam.ray_params()), CFG),
        4))
    assert float(((ref_den - ref) ** 2).mean()) < 0.1 * mse_noisy


def test_demodulation_preserves_checker_albedo():
    s = Scene(None)
    chk = s.add_checker((0.9, 0.9, 0.9), (0.1, 0.1, 0.1), scale=1.0)
    s.add_quad(20.0, 20.0, chk, ((1, 1, 1), (0, 0, 0), (0, 0, 0)))
    glow = s.add_emissive((3.0, 3.0, 3.0))
    s.add_sphere(1.0, glow, ((1, 1, 1), (0, 0, 0), (0.0, 2.0, 0.0)))
    cam = Camera((0.0, 10.0, 0.01), (0.0, -1.0, -0.001), 64, 64)
    film = _film(s, cam, CFG, 4)
    den = np.asarray(denoise_film(film, s.build(),
                                  jnp.asarray(cam.ray_params()), CFG,
                                  iterations=4))
    mid = den[32]
    bright = mid.sum(axis=1) > np.median(mid.sum(axis=1))
    # aggressive smoothing must NOT erase the checker: transitions remain
    assert np.abs(np.diff(bright.astype(int))).sum() >= 4


def test_filter_is_deterministic_and_finite():
    rng = np.random.default_rng(0)
    rad = jnp.asarray(rng.random((32, 48, 3)), jnp.float32)
    normal = jnp.zeros((32, 48, 3)).at[..., 1].set(1.0)
    albedo = jnp.full((32, 48, 3), 0.5)
    depth = jnp.full((32, 48), 3.0)
    a = np.asarray(atrous_denoise(rad, normal, albedo, depth, 3))
    b = np.asarray(atrous_denoise(rad, normal, albedo, depth, 3))
    assert np.array_equal(a, b)
    assert np.isfinite(a).all()
    # flat geometry + uniform albedo: heavy smoothing, variance collapses
    assert a.std() < 0.5 * np.asarray(rad).std()
