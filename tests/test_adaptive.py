"""Adaptive sampling engine (engines/adaptive.py — extension; every
reference backend traces every pixel every frame, film.cu:57-99).

Load-bearing properties:
- warmup frames are BIT-identical to the fused engine (same ids, same
  RNG derivation);
- the film's per-pixel means stay unbiased under non-uniform coverage
  (statistical agreement with the uniform engine);
- the budget actually concentrates: weights are warmup+k with k>0 for
  reselected pixels and exactly warmup for never-reselected ones;
- equal-sample-budget convergence beats uniform sampling on a scene
  with concentrated noise (Cornell).
"""

import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera

pytestmark = pytest.mark.slow  # fused-engine interpret renders

CFG = RenderConfig(width=64, height=32, max_depth=5, seed=3,
                   intersect_chunk=32, ray_tile=1 << 16)


def render(engine, preset, cfg, frames, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, Scene(preset), default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return film, r


def test_warmup_bit_matches_fused():
    fa, _ = render("adaptive", ScenePreset.MATERIAL_TEST, CFG, 3, warmup=4)
    fu, _ = render("fused", ScenePreset.MATERIAL_TEST, CFG, 3)
    assert np.array_equal(np.asarray(fa.hdr_average()),
                          np.asarray(fu.hdr_average()))


def test_budget_concentrates_and_mean_stays_unbiased():
    fa, ra = render("adaptive", ScenePreset.MATERIAL_TEST, CFG, 12, warmup=3, budget=0.5)
    fu, _ = render("fused", ScenePreset.MATERIAL_TEST, CFG, 12)
    a = np.asarray(fa.hdr_average())
    u = np.asarray(fu.hdr_average())
    assert np.isfinite(a).all()
    assert abs(a.mean() - u.mean()) / u.mean() < 0.02
    w = np.asarray(fa.weights)[np.asarray(ra._valid)]
    assert w.min() == 3.0          # warmup covers every pixel
    assert w.max() > 3.0           # ...and noisy pixels got more
    # total samples spent = warmup * all + 9 * budget
    spent = w.sum()
    expect = 3 * w.size + 9 * ra._budget_slots
    assert abs(spent - expect) < 1e-3, (spent, expect)


def test_equal_budget_beats_uniform_on_cornell():
    cfg = CFG.replace(width=48, height=48, max_depth=4)
    ref = np.asarray(render("megakernel", ScenePreset.CORNELL,
                            cfg.replace(seed=9), 128)[0].hdr_average())
    mse = lambda im: float(((im - ref) ** 2).mean())
    # 6 full-frame equivalents each: uniform 6 vs adaptive 3 + 6 halves
    # (measured ratio ~0.61; larger configs gave 0.56 — see STATUS.md)
    u = np.asarray(render("fused", ScenePreset.CORNELL, cfg, 6)[0].hdr_average())
    a = np.asarray(render("adaptive", ScenePreset.CORNELL, cfg, 9, warmup=3, budget=0.5)[0].hdr_average())
    assert mse(a) < 0.8 * mse(u), (mse(u), mse(a))


def test_reset_progressive_clears_stats():
    _, r = render("adaptive", ScenePreset.MATERIAL_TEST, CFG, 6, warmup=2)
    assert float(np.asarray(r._n).max()) > 0
    r.reset_progressive()
    assert float(np.asarray(r._n).max()) == 0.0
    assert r.frame_index == 0
