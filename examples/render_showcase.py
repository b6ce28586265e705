#!/usr/bin/env python
"""Render the BASELINE.md milestone configs into examples/outputs/.

Usage: python examples/render_showcase.py [cpu] [quick]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs")


def main():
    import jax
    cpu = "cpu" in sys.argv[1:]
    quick = "quick" in sys.argv[1:]
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)

    import numpy as np

    from parallelraytracing_tpu import (Film, RenderConfig, Scene,
                                        ScenePreset, create_renderer)

    on_gpu = jax.devices()[0].platform == "gpu"
    # the trace-kernel engines need a GPU; elsewhere the jnp engines
    fast = "fused" if on_gpu else "megakernel"
    mesh_engine = "wavefront_fused" if on_gpu else "bvh"
    from parallelraytracing_tpu.core.camera import Camera, default_camera
    from parallelraytracing_tpu.core.mesh import icosphere

    scale = 0.5 if quick else 1.0

    def render(name, scene, cam, engine, w, h, frames, depth=10, **kw):
        w, h, frames = int(w * scale), int(h * scale), max(2, int(frames * scale))
        cfg = RenderConfig(width=w, height=h, max_depth=depth, seed=0, **kw)
        film = Film(w, h)
        r = create_renderer(engine)
        t0 = time.time()
        r.init(film, scene, cam, cfg)
        for _ in range(frames):
            r.progressive_render()
        jax.block_until_ready(film.accum)
        dt = time.time() - t0
        path = os.path.join(OUT, f"{name}.png")
        film.save_png(path)
        print(f"{name:24s} {engine:10s} {w}x{h} {frames}f "
              f"{dt:6.1f}s -> {path}", flush=True)

    # BASELINE config 1: Cornell, 256x256, brute force
    render("cornell", Scene(ScenePreset.CORNELL),
           default_camera(256, 256), fast, 256, 256, 64)

    # Cornell with next-event estimation: converges in a fraction of the
    # frames.
    render("cornell_nee_8spp", Scene(ScenePreset.CORNELL),
           default_camera(256, 256), fast, 256, 256, 8, nee=True)

    # Material test (the BSDF fixture, scene.cpp:307-330)
    render("material_test", Scene(ScenePreset.MATERIAL_TEST),
           default_camera(512, 288), fast, 512, 288, 64)

    # Headline: 809-primitive random balls
    pos = np.array([30.0, 18.0, 30.0])
    render("random_balls_large", Scene(ScenePreset.RANDOM_BALLS_LARGE),
           Camera(pos, -pos, 640, 360), fast, 640, 360, 32, depth=20)

    # BASELINE config 2: a 20k-triangle procedural mesh through the BVH
    s = Scene(preset=None)
    body = s.add_lambertian((0.75, 0.65, 0.5))
    s.add_mesh(icosphere(5, seed=1), body, ((8, 8, 8), (0, 0, 0), (0, 8, 0)))
    ground = s.add_lambertian((0.5, 0.5, 0.5))
    s.add_quad(100, 100, ground, None)
    light = s.add_emissive((12, 12, 12))
    s.add_sphere(3.0, light, ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
    eye = np.array([0.0, 14.0, 28.0])
    look = np.array([0.0, 7.0, 0.0])
    render("mesh_20k", s, Camera(eye, look - eye, 512, 512), mesh_engine,
           512, 512, 8, depth=6)

    # BASELINE config 3-ish: an 82k-triangle metal mesh beside glass
    s = Scene(preset=None)
    body = s.add_metal((0.8, 0.6, 0.4), 0.15)
    s.add_mesh(icosphere(6, seed=3), body,
               ((10, 10, 10), (0, 0, 0), (0, 10, 0)))
    glass = s.add_dielectric(1.5)
    s.add_sphere(3.0, glass, ((1, 1, 1), (0, 0, 0), (-12, 3, 8)))
    ground = s.add_lambertian((0.4, 0.4, 0.45))
    s.add_quad(120, 120, ground, None)
    light = s.add_emissive((10, 9, 8))
    s.add_sphere(4.0, light, ((1, 1, 1), (0, 0, 0), (15, 30, 15)))
    eye = np.array([0.0, 16.0, 32.0])
    look = np.array([0.0, 8.0, 0.0])
    render("mesh_82k_metal", s, Camera(eye, look - eye, 512, 512),
           mesh_engine, 512, 512, 8, depth=8)

    # BASELINE config 4: multi-mesh scene through TRUE TLAS/BLAS
    # instancing — geometry memory proportional to unique meshes (two
    # procedural meshes, each BLAS stored once; 7 instances).
    ico = icosphere(1, seed=2)
    bun = icosphere(5, seed=1)
    s = Scene(preset=None)
    body = s.add_lambertian((0.7, 0.6, 0.45))
    s.add_mesh_instances(bun, body, [((6, 6, 6), (0, 160, 0), (0, 6, 0)),
                                     ((3, 3, 3), (0, 40, 0), (-12, 3, 6))])
    glass = s.add_dielectric(1.5)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    s.add_mesh_instances(ico, glass,
                         [((2.5,) * 3, (0, 30 * i, 0), (9 + 2.5 * i, 2.5,
                                                        8 - 3.0 * i))
                          for i in range(3)])
    s.add_mesh_instances(ico, red, [((2,) * 3, (0, 15, 25), (-9, 2, 12)),
                                    ((1.5,) * 3, (30, 0, 0), (4, 1.5, 14))])
    ground = s.add_lambertian((0.5, 0.5, 0.52))
    s.add_quad(120, 120, ground, None)
    light = s.add_emissive((11, 11, 10))
    s.add_sphere(3.5, light, ((1, 1, 1), (0, 0, 0), (14, 26, 14)))
    eye = np.array([0.0, 12.0, 30.0])
    look = np.array([0.0, 5.0, 0.0])
    # `tlas` is the fused in-kernel TLAS/BLAS path; without a GPU the
    # jnp mirror `tlas_ref`
    render("multimesh_tlas", s, Camera(eye, look - eye, 512, 288),
           "tlas" if on_gpu else "tlas_ref", 512, 288, 8, depth=6)

    # Extensions: checker textures + thin-lens depth of field — the texture_demo preset with an open aperture
    # focused on the second sphere row.
    s = Scene(ScenePreset.TEXTURE_DEMO)
    eye = np.array([0.0, 4.0, 14.0])
    look = np.array([0.0, 1.0, 0.0])
    w, h, frames = int(512 * scale), int(288 * scale), max(2, int(24 * scale))
    cfg = RenderConfig(width=w, height=h, max_depth=8, seed=0,
                       lens_radius=0.35, focus_distance=12.0)
    film = Film(w, h)
    r = create_renderer(fast)
    t0 = time.time()
    r.init(film, s, Camera(eye, look - eye, w, h), cfg)
    for _ in range(frames):
        r.progressive_render()
    jax.block_until_ready(film.accum)
    path = os.path.join(OUT, "texture_demo_dof.png")
    film.save_png(path)
    print(f"{'texture_demo_dof':24s} {fast:10s} {w}x{h} {frames}f "
          f"{time.time() - t0:6.1f}s -> {path}", flush=True)


if __name__ == "__main__":
    main()
