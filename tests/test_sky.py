"""Sky-model extension (Scene.set_sky): gradient + analytic sun.

The reference hardcodes ONE constant sky in four places
(cpu/renderer.h:31, cuda_megakernel/renderer.cu:159,
cuda_wavefront/renderer.cu:404, optix/renderer.cpp:41-43).  Here the sky
is a model: constant (default — bit-identical to the reference
semantics), horizon->zenith gradient (RTiOW lerp on the normalized ray
y), and an additive power-cosine sun disc.  The jnp engines evaluate
ops/sky.sky_radiance; the Pallas kernels compile the same math from a
static spec — these tests pin the two paths to each other.
"""

import jax
import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera

pytestmark = pytest.mark.slow  # Pallas interpret sky renders

CFG = RenderConfig(width=64, height=48, max_depth=3, seed=0, jitter=False,
                   intersect_chunk=32, ray_tile=1 << 16)


def sky_scene(sun=True):
    # Emissive geometry only: paths terminate deterministically at the
    # first hit (material.h:119-122), so with jitter off every engine
    # traces the IDENTICAL rays regardless of its RNG stream — the image
    # compares the sky models alone, not Monte-Carlo noise.
    s = Scene(preset=None)
    m = s.add_emissive((0.2, 0.3, 0.2))
    s.add_sphere(1.0, m, ((1, 1, 1), (0, 0, 0), (0, -0.2, 0)))
    s.set_sky(bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0),
              sun_direction=(0.3, 0.8, -0.2) if sun else None,
              sun_color=(5, 4, 3) if sun else None, sun_power=32)
    if not sun:
        s.set_sky(bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0))
    return s


def render(engine, scene, cfg=CFG, frames=1, **attrs):
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


def test_sky_radiance_math():
    """Direct check of ops/sky.sky_radiance against a numpy evaluation
    (unnormalized directions exercise the normalization)."""
    from parallelraytracing_tpu.ops.sky import sky_radiance
    s = sky_scene().build()
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32) * 2.0
    got = np.asarray(sky_radiance(s, jax.numpy.asarray(d)))
    dn = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = 0.5 * (dn[:, 1] + 1.0)
    want = (1 - t)[:, None] * np.array([1.0, 1.0, 1.0]) \
        + t[:, None] * np.array([0.5, 0.7, 1.0])
    sd = np.array([0.3, 0.8, -0.2])
    sd = sd / np.linalg.norm(sd)
    w = np.maximum(dn @ sd, 0.0) ** 32
    want = want + w[:, None] * np.array([5.0, 4.0, 3.0])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_constant_sky_unchanged():
    """Scenes that never call set_sky keep the EXACT constant-sky path:
    SceneData.sky_top/sun are None and the static kernel spec is the
    3-tuple (goldens already pin the images; this pins the plumbing)."""
    s = Scene(ScenePreset.MATERIAL_TEST)
    data = s.build()
    assert data.sky_top is None and data.sun is None
    from parallelraytracing_tpu.ops.trace_kernel import pack_scene
    t = pack_scene(s, CFG.nee)
    assert len(t.sky) == 3


def test_jnp_engines_agree():
    # Same threefry streams; XLA fuses the sky lerp differently across
    # the two program shapes (full-array vs compacted-queue eval), so
    # agreement is to float tolerance (~4e-7 observed), not bitwise as
    # in the constant-sky fidelity table.
    a = render("megakernel", sky_scene())
    b = render("wavefront", sky_scene())
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_pallas_engines_match_jnp_sky():
    """With jitter off and every ray escaping or bouncing off one
    lambertian sphere, the Pallas kernels' in-kernel sky must equal the
    jnp model to float tolerance (rsqrt vs 1/sqrt ulp)."""
    a = render("megakernel", sky_scene())
    b = render("fused", sky_scene())
    c = render("wavefront_fused", sky_scene(), schedule=(2,))
    assert np.abs(a - b).max() < 1e-5 * max(1.0, float(a.max()))
    np.testing.assert_array_equal(b, c)


def test_gradient_without_sun():
    a = render("megakernel", sky_scene(sun=False))
    b = render("fused", sky_scene(sun=False))
    assert np.isfinite(a).all()
    # top of frame reads less red (gradient toward the blue zenith;
    # blue stays 1.0 end to end in this spec, red lerps 1.0 -> 0.5)
    assert a[:8, :, 0].mean() < a[-8:, :, 0].mean()
    assert np.abs(a - b).max() < 1e-5 * max(1.0, float(a.max()))


def test_sky_demo_preset_renders():
    cfg = CFG.replace(max_depth=4)
    img = render("fused", Scene(ScenePreset.SKY_DEMO), cfg, frames=2)
    assert np.isfinite(img).all() and img.max() > 0.5
