"""The compiled trace kernel on a CUDA GPU (pytest --gpu).

Without a card these skip; chip_smoke.py runs the same comparisons at
full width."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.ops import trace_kernel as tk
from parallelraytracing_tpu.ops.intersect import intersect_scene

pytestmark = pytest.mark.gpu

CFG = RenderConfig(width=64, height=48, max_depth=6, seed=0)


def test_compiled_closest_hit_matches_intersect(gpu):
    scene = Scene(ScenePreset.RANDOM_BALLS_SMALL)
    tables = tk.pack_scene(scene, nee=False)
    data = scene.build()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    o = jax.random.uniform(k1, (4096, 3), minval=-5.0, maxval=5.0) \
        + jnp.array([0.0, 6.0, 0.0])
    d = jax.random.normal(k2, (4096, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    t, ordv = tk.closest_hit(tables, o, d, CFG)
    with jax.default_matmul_precision("highest"):
        ref = intersect_scene(data, o, d, CFG.t_min, CFG.t_max)
    n_sph = data.sph_center.shape[0]
    n_quad = data.quad_normal.shape[0]
    base = jnp.where(ref.kind == 0, 0, jnp.where(ref.kind == 1, n_sph,
                                                 n_sph + n_quad))
    ref_ord = np.where(np.asarray(ref.hit), np.asarray(base + ref.idx), -1)
    assert (np.asarray(ordv) == ref_ord).mean() >= 0.999


def test_compiled_fused_bitmatches_wavefront_fused(gpu):
    imgs = []
    for engine in ("fused", "wavefront_fused"):
        film = Film(CFG.width, CFG.height)
        r = create_renderer(engine)
        r.init(film, Scene(ScenePreset.MATERIAL_TEST),
               default_camera(CFG.width, CFG.height), CFG)
        for _ in range(4):
            r.progressive_render()
        imgs.append(np.asarray(film.hdr_average()))
    np.testing.assert_array_equal(imgs[0], imgs[1])
