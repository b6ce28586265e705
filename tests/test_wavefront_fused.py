"""wavefront_fused engine: segment+sort correctness.

The load-bearing property is permutation invariance: RNG is keyed on
(pixel id, absolute depth) inside the kernel, so compaction and the
between-segment Morton re-sort must leave the image BIT-identical to the
unsorted run — the kernel's answer to the reference wavefront's
determinism-under-queue-order concern (warp-aggregated queues,
cuda_wavefront/renderer.cu:43-100)."""

import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera

pytestmark = pytest.mark.slow  # segment-kernel interpret renders


def render(engine, preset, cfg, frames=8, **attrs):
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


CFG = RenderConfig(width=64, height=32, max_depth=6, seed=3,
                   intersect_chunk=32, ray_tile=1 << 16)


def test_sort_is_bit_invariant():
    imgs = [render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG,
                   frames=2, schedule=(2,), sort_rays=mode)
            for mode in ("octant", "origin", "")]
    assert np.array_equal(imgs[0], imgs[1]), "sort key changed the image"
    assert np.array_equal(imgs[0], imgs[2]), "re-sorting changed the image"


def test_segment_size_is_bit_invariant():
    a = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=2,
               schedule=(2,))
    b = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=2,
               schedule=(3,))
    assert np.array_equal(a, b), "segment size changed the image"


def test_segment_schedule_is_bit_invariant():
    # A non-uniform schedule (short first segment = early compaction of
    # the bounce-1 sky deaths) must render the bit-identical image: RNG
    # is keyed on (pixel, absolute depth), never on segment boundaries.
    a = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=2,
               schedule=(3,))
    b = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=2,
               schedule=(1, 3))
    assert np.array_equal(a, b), "segment schedule changed the image"
    c = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=2,
               schedule=(1, 2, 4))
    assert np.array_equal(a, c), "full schedule changed the image"


def test_statistically_matches_oracle():
    a = render("megakernel", ScenePreset.MATERIAL_TEST, CFG, frames=24)
    b = render("wavefront_fused", ScenePreset.MATERIAL_TEST, CFG, frames=24)
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.05
    close = np.abs(a - b) < 0.25 * (a + b) + 0.05
    assert close.mean() > 0.85


def test_finite_on_cornell():
    img = render("wavefront_fused", ScenePreset.CORNELL, CFG, frames=2, schedule=(2,))
    assert np.isfinite(img).all() and (img >= 0).all()
