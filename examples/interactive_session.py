#!/usr/bin/env python
"""Scripted interactive-session capture: the composition milestone — motion-adaptive PREVIEW twin while orbiting,
ADAPTIVE-sampling steady-state refinement at rest, and the a-trous
DENOISER on the displayed frame — driven through the REAL viewer loop
(viewer/app.ViewerState._step, the main.cpp:194-549 analogue), not a
synthetic benchmark.

Two sessions, the verdict's bars:
- mesh orbit  (20k-triangle procedural mesh) at 512x384: sustained >= 15
  fps while orbiting
- sphere orbit (texture_demo) at 1280x720: sustained >= 10 fps

Each session records sustained orbit fps (wall frames/sec over the
whole motion phase, preview twin active), the steady-state per-stage
ms trace (render/tonemap/encode from the viewer's own 100-frame
history), and writes PNGs: the in-motion preview snapshot and the
settled adaptive+denoised frame.  Summary lines go to stdout.

Usage: python examples/interactive_session.py [outdir]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def run_session(tag, scene, camera, cfg, engine, preview_scale, outdir,
                orbit_s=6.0, settle_s=6.0, spin=10.0):
    from parallelraytracing_tpu.utils.compile_cache import \
        enable_compile_cache
    from parallelraytracing_tpu.viewer.app import ViewerState

    enable_compile_cache()

    state = ViewerState(scene, camera, cfg, engine,
                        preview_scale=preview_scale,
                        display_interval_ms=150.0)
    state.denoise = True

    # warm-up: compile the settled adaptive program (warmup frames +
    # first adaptive frame + denoised display), then the orbit preview
    for _ in range(7):
        state._step(0.016)
    state.control({"kind": "rotate", "dx": 4.0, "dy": 0.0})
    state._step(0.016)
    while state.camera.update(0.05):  # drain orbit velocity
        pass
    for _ in range(2):
        state._step(0.016)

    # ---- phase A: continuous orbit (preview twin active)
    frames0 = state.frame
    t0 = time.time()
    last = t0
    preview_png = None
    while time.time() - t0 < orbit_s:
        now = time.time()
        dt = min(now - last, 0.1)
        last = now
        state.control({"kind": "rotate", "dx": spin * max(dt, 1e-3) * 60,
                       "dy": 0.0})
        state._step(dt if dt > 0 else 0.016)
        if preview_png is None and state.previewing and state.png_cache:
            preview_png = state.png_cache
    orbit_wall = time.time() - t0
    orbit_frames = state.frame - frames0
    orbit_fps = orbit_frames / orbit_wall
    was_previewing = state.previewing
    if state.png_cache:
        preview_png = state.png_cache

    # ---- phase B: release the orbit, steady-state refinement
    while state.camera.update(0.05):
        pass
    frames1 = state.frame
    t1 = time.time()
    last = t1
    while time.time() - t1 < settle_s:
        now = time.time()
        dt = min(now - last, 0.1)
        last = now
        state._step(dt if dt > 0 else 0.016)
    settle_wall = time.time() - t1
    settle_fps = (state.frame - frames1) / settle_wall
    spp = state.film.sample_count

    hist = {k: list(v) for k, v in state.history.items()}
    n = min(20, len(hist["render"]))
    stage = {k: round(float(np.mean(v[-n:])), 2)
             for k, v in hist.items() if v}

    os.makedirs(outdir, exist_ok=True)
    if preview_png:
        with open(f"{outdir}/interactive_{tag}_r5_preview.png", "wb") as f:
            f.write(preview_png)
    state.stop = True
    time.sleep(0.3)
    if state.png_cache:
        with open(f"{outdir}/interactive_{tag}_r5_settled.png", "wb") as f:
            f.write(state.png_cache)

    print(f"[{tag}] {cfg.width}x{cfg.height} engine={engine} "
          f"preview=1/{preview_scale}")
    print(f"[{tag}] ORBIT: {orbit_frames} frames / {orbit_wall:.1f} s = "
          f"{orbit_fps:.1f} fps sustained (previewing={was_previewing})")
    print(f"[{tag}] SETTLED: {settle_fps:.1f} fps refinement, "
          f"{spp} spp accumulated, denoised display")
    print(f"[{tag}] per-stage ms (last {n} frames): {stage}")
    return orbit_fps, settle_fps, stage


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "examples/outputs"
    import numpy as np

    from parallelraytracing_tpu import RenderConfig, Scene, ScenePreset
    from parallelraytracing_tpu.core.camera import Camera
    from parallelraytracing_tpu.core.scene import procedural_mesh_scene

    # session 1: mesh orbit at 512x384 (bar: >= 15 fps sustained)
    s, cam_pos, look = procedural_mesh_scene(5)
    w, h = 512, 384
    cfg = RenderConfig(width=w, height=h, max_depth=8, seed=0,
                       russian_roulette_depth=2)
    cam = Camera(np.array([0.0, 12.0, 26.0]),
                 np.array([0.0, -6.0, -26.0]), float(w), float(h), 100.0)
    mesh_fps, _, _ = run_session("mesh", s, cam, cfg, "adaptive", 3,
                                 outdir)

    # session 2: sphere-scene orbit at 720p (bar: >= 10 fps sustained)
    w, h = 1280, 720
    cfg = RenderConfig(width=w, height=h, max_depth=8, seed=0,
                       russian_roulette_depth=2)
    cam = Camera(np.array([0.0, 5.0, 14.0]),
                 np.array([0.0, -4.0, -14.0]), float(w), float(h), 100.0)
    sph_fps, _, _ = run_session("texdemo720", Scene(ScenePreset.TEXTURE_DEMO),
                                cam, cfg, "adaptive", 3, outdir)

    # session 3: 1080p orbit (BASELINE milestone 5's resolution; the
    # preview twin carries motion, adaptive+denoise carry the refine)
    w, h = 1920, 1080
    cfg = RenderConfig(width=w, height=h, max_depth=8, seed=0,
                       russian_roulette_depth=2)
    cam = Camera(np.array([0.0, 5.0, 14.0]),
                 np.array([0.0, -4.0, -14.0]), float(w), float(h), 100.0)
    hd_fps, _, _ = run_session("texdemo1080", Scene(ScenePreset.TEXTURE_DEMO),
                               cam, cfg, "adaptive", 4, outdir)

    ok = mesh_fps >= 15.0 and sph_fps >= 10.0
    print(f"BARS: mesh {mesh_fps:.1f}/15 fps, sphere {sph_fps:.1f}/10 fps "
          f"-> {'PASS' if ok else 'MISS'}; 1080p orbit {hd_fps:.1f} fps")


if __name__ == "__main__":
    main()
