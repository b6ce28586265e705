#!/usr/bin/env python
"""Animated-geometry demo: per-frame BVH refit (BASELINE config 5).

A sphere orbits over the ground plane; every frame the scene arrays move
and the BVH is leaf-recomputed + level-sweep refitted INSIDE the jitted
frame step (accel/refit.py via the bvh engine's `animate` hook) — the
thing the reference cannot do (its OptiX AS is built once at Init and
never refit, optix/renderer.cpp:703-871).

Writes animated_refit_f{N}.png frames into examples/outputs/.
Runs on any platform (the bvh engine is plain JAX); --platform cpu forces
the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=200)
    args = p.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from parallelraytracing_tpu import Film, RenderConfig, Scene, create_renderer
    from parallelraytracing_tpu.core.camera import Camera

    scene = Scene(preset=None)
    red = scene.add_lambertian((0.9, 0.15, 0.1))
    scene.add_sphere(1.5, red, ((1, 1, 1), (0, 0, 0), (6, 1.5, 0)))
    mirror = scene.add_metal((0.9, 0.9, 0.9), 0.02)
    scene.add_sphere(2.0, mirror, ((1, 1, 1), (0, 0, 0), (0, 2, -3)))
    ground = scene.add_lambertian((0.55, 0.55, 0.55))
    scene.add_quad(60, 60, ground, None)
    light = scene.add_emissive((14, 14, 14))
    scene.add_sphere(1.5, light, ((1, 1, 1), (0, 0, 0), (-6, 10, 6)))

    def animate(sd, frame):
        """Red sphere orbits the mirror ball (radius 6, 1/12 turn/frame)."""
        ang = frame.astype(jnp.float32) * (2.0 * math.pi / 12.0)
        c = sd.sph_center
        c = c.at[0, 0].set(6.0 * jnp.cos(ang))
        c = c.at[0, 2].set(-3.0 + 6.0 * jnp.sin(ang))
        return dataclasses.replace(sd, sph_center=c)

    cfg = RenderConfig(width=args.width, height=args.height, max_depth=6,
                       seed=0, samples_per_frame=1)
    eye = np.array([0.0, 8.0, 14.0])
    cam = Camera(eye, np.array([0.0, 1.5, -2.0]) - eye,
                 float(args.width), float(args.height), 100.0)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "outputs")
    os.makedirs(out_dir, exist_ok=True)

    r = create_renderer("bvh")
    r.animate = animate
    for f in range(args.frames):
        film = Film(args.width, args.height)
        r.init(film, scene, cam, cfg)
        r._frame_index = f
        for _ in range(args.spp):  # accumulate spp samples AT this pose
            r.progressive_render()
            r._frame_index = f
        path = os.path.join(out_dir, f"animated_refit_f{f}.png")
        film.save_png(path)
        print(f"frame {f}: sphere orbits; refit tree; wrote {path}")


if __name__ == "__main__":
    main()
