"""Thin-lens depth of field (an extension — every reference camera is
pinhole, /root/reference/src/core/camera.h:104-132).

Load-bearing properties:
- closed aperture (lens_radius=0) is BIT-identical to the pre-DoF pinhole
  path in every engine (the lens gate is static);
- every lens ray for a pixel passes through the same focal-plane point
  (the defining thin-lens invariant — points at focus_distance stay sharp);
- fused == wavefront_fused stays bit-exact with the aperture open (the
  lens sample is pixel-keyed, salts 103/104, so compaction/sort cannot
  change it);
- blur is real: with the aperture open, an out-of-focus edge spreads
  (neighboring-pixel variance drops) while the oracle and Pallas engines
  still agree statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.ops.rays import generate_camera_rays_ids

pytestmark = pytest.mark.slow  # Pallas interpret renders

CFG = RenderConfig(width=64, height=32, max_depth=6, seed=3,
                   intersect_chunk=32, ray_tile=1 << 16)
DOF = CFG.replace(lens_radius=0.35, focus_distance=9.0)


def render(engine, cfg, frames=8, preset=ScenePreset.MATERIAL_TEST, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, Scene(preset), default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def test_closed_aperture_is_pinhole_bit_exact():
    # lens_radius=0 must take the static pinhole path: same rays, same
    # RNG draws, bit-identical frames.
    for engine in ("megakernel", "fused"):
        a = render(engine, CFG, frames=2)
        b = render(engine, CFG.replace(lens_radius=0.0, focus_distance=4.2),
                   frames=2)
        assert np.array_equal(a, b), engine


def test_lens_rays_share_the_focal_point():
    cam = default_camera(64, 32)
    params = jnp.asarray(cam.ray_params())
    front = params[9:12]
    idx = jnp.full((1,), 1000, jnp.int32)
    lens = (0.5, 7.0)
    pts, origins = [], []
    # The lens sample is pixel-keyed: one aperture point per (pixel, seed).
    # Draw the disk by varying the frame seed.
    for seed in range(16):
        o, d = generate_camera_rays_ids(params, 64, 32, idx, None,
                                        jitter=False,
                                        pix_seed=jnp.uint32(seed * 7919),
                                        lens=lens)
        t = lens[1] / jnp.einsum("rj,j->r", d, front)
        pts.append(np.asarray(o + d * t[:, None]))
        origins.append(np.asarray(o))
    # The aperture really opened: origins differ across seeds...
    assert np.ptp(np.concatenate(origins), axis=0).max() > 1e-3
    pts = np.concatenate(pts)
    assert np.ptp(pts, axis=0).max() < 1e-4, "lens rays missed the focus"


def test_fused_equals_wavefront_fused_with_open_aperture():
    a = render("fused", DOF, frames=2)
    b = render("wavefront_fused", DOF, frames=2, schedule=(2,))
    assert np.array_equal(a, b), "DoF broke the pixel-keyed bit-identity"


def _silhouette_scene():
    """One emissive sphere against a BLACK sky: with a pinhole the
    silhouette is hard (pixels off the disc are exactly 0); an open
    aperture spreads emission into neighboring pixels, so the set of
    lit pixels strictly grows — a noise-proof defocus detector."""
    s = Scene(None)
    s.sky_light_intensity = 0.0
    s.use_sky_intensity = True
    s.sky_color = np.zeros(3)
    glow = s.add_emissive((4.0, 4.0, 4.0))
    s.add_sphere(1.2, glow, ((1.0, 1.0, 1.0), (0, 0, 0), (0.0, 0.0, 0.0)))
    return s


def _render_scene(engine, scene, cfg, frames, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def test_open_aperture_spreads_the_silhouette():
    # Eye is at (5,5,8), ~10.7 from the sphere; focus well short of it so
    # the sphere is strongly out of focus.
    sharp = _render_scene("fused", _silhouette_scene(), CFG, 8)
    blurred = _render_scene("fused", _silhouette_scene(),
                            CFG.replace(lens_radius=2.0, focus_distance=4.0),
                            8)
    lit = lambda im: int((im.sum(axis=1) > 1e-4).sum())
    assert lit(blurred) > lit(sharp) * 1.2, (lit(sharp), lit(blurred))
    # Same light transport: the oracle agrees statistically under the lens.
    oracle = _render_scene("megakernel", _silhouette_scene(),
                           CFG.replace(lens_radius=2.0, focus_distance=4.0),
                           24)
    pallas = _render_scene("fused", _silhouette_scene(),
                           CFG.replace(lens_radius=2.0, focus_distance=4.0),
                           24)
    assert abs(oracle.mean() - pallas.mean()) / max(oracle.mean(), 1e-6) < 0.05
