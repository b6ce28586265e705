"""Next-event estimation: unbiasedness (same mean as the plain estimator)
and effectiveness (lower error at equal spp on emissive-lit scenes)."""

import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera

pytestmark = pytest.mark.slow  # converged jnp + Pallas interpret NEE renders


def render(preset, nee: bool, frames: int, seed=0, engine="megakernel"):
    cfg = RenderConfig(width=48, height=32, max_depth=6, seed=seed,
                       intersect_chunk=32, ray_tile=1 << 16, nee=nee)
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    r.init(film, Scene(preset), default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def test_extract_lights_finds_emissives():
    from parallelraytracing_tpu.ops.nee import extract_lights
    lights = extract_lights(Scene(ScenePreset.LIGHT_TEST).build())
    assert lights is not None and lights.count == 11  # 11 emissive spheres
    lights = extract_lights(Scene(ScenePreset.CORNELL).build())
    assert lights is not None and lights.count == 1   # the ceiling quad
    assert extract_lights(Scene(ScenePreset.MATERIAL_TEST).build()) is None


@pytest.mark.parametrize("preset", [ScenePreset.LIGHT_TEST,
                                    ScenePreset.CORNELL])
def test_nee_is_unbiased_and_lowers_error(preset):
    # Converged truth from the plain estimator.
    truth = render(preset, nee=False, frames=192)
    plain = render(preset, nee=False, frames=8, seed=9)
    nee = render(preset, nee=True, frames=8, seed=9)

    # Same expectation: means agree within Monte-Carlo tolerance.
    assert abs(nee.mean() - truth.mean()) / max(truth.mean(), 1e-6) < 0.06

    # Effectiveness: at 8 spp the NEE render is much closer to truth.
    rmse_plain = float(np.sqrt(np.mean((plain - truth) ** 2)))
    rmse_nee = float(np.sqrt(np.mean((nee - truth) ** 2)))
    assert rmse_nee < 0.6 * rmse_plain, (rmse_nee, rmse_plain)


def test_nee_bvh_matches_megakernel_stream():
    # Same estimator + same RNG stream through a different intersector.
    a = render(ScenePreset.CORNELL, nee=True, frames=4, engine="megakernel")
    b = render(ScenePreset.CORNELL, nee=True, frames=4, engine="bvh")
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_nee_wavefront_matches_megakernel_stream():
    # The compaction engine's NEE block (engines/wavefront.py) ports the
    # tracer's estimator over the queue layout; pixel-keyed streams make
    # the result identical to the megakernel despite the reordering.
    a = render(ScenePreset.CORNELL, nee=True, frames=4, engine="megakernel")
    b = render(ScenePreset.CORNELL, nee=True, frames=4, engine="wavefront")
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_in_kernel_nee_fused_unbiased():
    # The Pallas engines run their own in-kernel NEE (pallas_trace.py);
    # same estimator, different RNG stream: means agree with the jnp
    # NEE render and with the converged plain truth.
    truth = render(ScenePreset.CORNELL, nee=False, frames=96)
    f = render(ScenePreset.CORNELL, nee=True, frames=8, engine="fused")
    assert abs(f.mean() - truth.mean()) / max(truth.mean(), 1e-6) < 0.06
    plain = render(ScenePreset.CORNELL, nee=False, frames=8, seed=1,
                   engine="fused")
    rmse_plain = float(np.sqrt(np.mean((plain - truth) ** 2)))
    rmse_nee = float(np.sqrt(np.mean((f - truth) ** 2)))
    assert rmse_nee < 0.6 * rmse_plain, (rmse_nee, rmse_plain)


def test_in_kernel_nee_wavefront_fused_bitmatches_fused():
    a = render(ScenePreset.CORNELL, nee=True, frames=3, engine="fused")
    b = render(ScenePreset.CORNELL, nee=True, frames=3,
               engine="wavefront_fused")
    assert np.array_equal(a, b)
