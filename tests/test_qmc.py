"""QMC camera sampling (cfg.qmc) — an extension; every reference backend
is plain MC (curand / frame-hashed PCG, SURVEY §3.6 RNG notes).

Design under test (ops/rays.halton_qpt / qmc_rotation_seed / _rot):
- the sub-pixel jitter and thin-lens aperture draw Halton points
  (bases 2,3 / 5,7), Cranley-Patterson-rotated per pixel with a
  frame-INDEPENDENT pixel-keyed seed, so each pixel's camera samples
  over the progressive frames form a rotated low-discrepancy sequence;
- the rotation is keyed on the pixel id alone, so the Pallas engines'
  layout/order invariance and bit-identity contracts survive;
- path-vertex sampling stays plain MC (the in-kernel PCG is untouched).
"""

import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.ops.rays import (halton_qpt, qmc_rotation_seed,
                                             radical_inverse)
import pytest

pytestmark = pytest.mark.slow  # equal-budget render comparisons

CFG = RenderConfig(width=64, height=32, max_depth=6, seed=3,
                   intersect_chunk=32, ray_tile=1 << 16, qmc=True)
DOF = CFG.replace(lens_radius=0.35, focus_distance=9.0)


def _render(engine, cfg, frames=2, preset=ScenePreset.MATERIAL_TEST,
            scene=None, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, scene if scene is not None else Scene(preset),
           default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def test_radical_inverse_exact():
    # Van der Corput base 2: bit-reversed fractions.
    assert [radical_inverse(i, 2) for i in range(8)] == \
        [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]
    # Base 3 begins 0, 1/3, 2/3, 1/9, 4/9, 7/9.
    np.testing.assert_allclose(
        [radical_inverse(i, 3) for i in range(6)],
        [0.0, 1 / 3, 2 / 3, 1 / 9, 4 / 9, 7 / 9], rtol=1e-12)
    q = halton_qpt(5)
    np.testing.assert_allclose(
        q, [radical_inverse(5, b) for b in (2, 3, 5, 7)], rtol=1e-6)


def test_rotated_sequence_is_stratified():
    # For ANY pixel rotation, the first 16 base-2 jitter values land one
    # per 1/16 stratum (the property independent uniforms lack) — the
    # defining stratification the engines inherit.
    from parallelraytracing_tpu.ops.rays import _pixel_u01, _rot
    seed = qmc_rotation_seed(3)
    for pixel in (0, 917, 2047):
        rot = _pixel_u01(jnp.full((1,), pixel, jnp.int32), seed, 101)
        xs = np.array([float(_rot(rot, jnp.float32(halton_qpt(g)[0]))[0])
                       for g in range(16)])
        strata = np.sort((xs * 16).astype(int))
        assert (strata == np.arange(16)).all(), (pixel, np.sort(xs))
    # Different pixels get different rotations (decorrelation).
    r0 = float(_pixel_u01(jnp.zeros((1,), jnp.int32), seed, 101)[0])
    r1 = float(_pixel_u01(jnp.ones((1,), jnp.int32), seed, 101)[0])
    assert abs(r0 - r1) > 1e-4


def test_qmc_changes_the_image_and_stays_deterministic():
    a = _render("fused", CFG, frames=2)
    b = _render("fused", CFG, frames=2)
    assert np.array_equal(a, b), "QMC frames must stay reproducible"
    c = _render("fused", CFG.replace(qmc=False), frames=2)
    assert not np.array_equal(a, c), "qmc=True silently no-oped"


def test_qmc_bit_contract_fused_wavefront_fused():
    # The fused-family bit-identity must survive QMC (the rotation is
    # pixel-keyed, the Halton point is a shared scalar).  Aperture open
    # so the lens dims (bases 5,7) are exercised too.
    a = _render("fused", DOF, frames=3)
    b = _render("wavefront_fused", DOF, frames=3, schedule=(2,))
    assert np.array_equal(a, b), "QMC broke the pixel-keyed bit-identity"


def test_qmc_sharded_matches_fused_bitwise():
    # qpt/rotation-seed threading through shard_map: the 8-virtual-device
    # sharded engine must produce the SAME image as single-chip fused
    # (device-count invariance of the pixel-keyed streams).
    a = _render("fused", DOF, frames=2)
    b = _render("sharded", DOF, frames=2)
    assert np.array_equal(a, b), "sharded QMC diverged from fused"


def test_every_engine_accepts_qmc():
    # No engine may silently reject or crash on cfg.qmc (the VERDICT r2
    # lesson from NEE: support everywhere or fail loudly — here the
    # raygen layer is shared, so everywhere is cheap).
    small = CFG.replace(width=32, height=16, max_depth=3)
    for engine in ("megakernel", "wavefront", "bvh", "wavefront_bvh",
                   "tlas", "fused", "wavefront_fused", "sharded",
                   "adaptive"):
        img = _render(engine, small, frames=1)
        assert np.isfinite(img).all(), engine


def _silhouette_scene():
    """Emissive sphere on a black sky: paths terminate at depth 1, so the
    ONLY sampled dimensions are the camera's (jitter + lens) — a pure
    detector for QMC variance reduction (same trick as test_dof.py)."""
    s = Scene(None)
    s.sky_light_intensity = 0.0
    s.use_sky_intensity = True
    s.sky_color = np.zeros(3)
    glow = s.add_emissive((4.0, 4.0, 4.0))
    s.add_sphere(1.2, glow, ((1.0, 1.0, 1.0), (0, 0, 0), (0.0, 0.0, 0.0)))
    return s


def test_qmc_converges_faster_on_defocus():
    # Strongly defocused emissive silhouette: all variance comes from the
    # 4 camera dimensions QMC stratifies.  At an equal 12-frame budget the
    # rotated-Halton estimate must beat independent uniforms clearly
    # against a converged (192-frame) reference.
    lens = CFG.replace(qmc=False, lens_radius=2.0, focus_distance=4.0,
                       max_depth=3)
    ref = _render("megakernel", lens, frames=192, scene=_silhouette_scene())
    mc = _render("megakernel", lens, frames=12, scene=_silhouette_scene())
    qm = _render("megakernel", lens.replace(qmc=True), frames=12,
                 scene=_silhouette_scene())
    mse = lambda im: float(((im - ref) ** 2).mean())
    assert mse(qm) < 0.6 * mse(mc), (mse(qm), mse(mc))
