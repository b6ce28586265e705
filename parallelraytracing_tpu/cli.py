"""Command-line renderer.

The reference has no CLI at all (`int main()` takes no arguments,
main.cpp:85; everything is a compile-time constant) — this is the required
improvement noted in SURVEY.md §5.  Renders N progressive frames of a
preset or PLY scene with any engine and writes a PNG (plus optional film
checkpoint for resuming — a capability the reference lacks entirely).

Usage:
    python -m parallelraytracing_tpu.cli --scene cornell --frames 64 \
        --engine bvh --width 512 --height 512 --out cornell.png
    python -m parallelraytracing_tpu.cli --ply assets/bunny.ply --frames 16
    python -m parallelraytracing_tpu.cli --mesh-level 7 --depth 8
    python -m parallelraytracing_tpu.cli --scene default \
        --resume ckpt.npz --checkpoint ckpt.npz
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallelraytracing_tpu",
        description="progressive Monte Carlo path tracer (JAX, GPU kernels)")
    p.add_argument("--scene", default="random_balls_large",
                   help="preset name (default, light_test, material_test, "
                        "cornell, random_balls_{small,medium,large}, or "
                        "the extension demos: texture_demo — checkered "
                        "floor, pairs well with --lens-radius; sky_demo — "
                        "gradient + analytic-sun sky, Scene.set_sky)")
    p.add_argument("--ply", default=None,
                   help="render a PLY mesh instead of a preset")
    p.add_argument("--mesh-level", type=int, default=None, metavar="L",
                   help="render the seeded procedural mesh of 20*4^L "
                        "triangles (core/mesh.icosphere; 7 = 327,680) "
                        "instead of a preset")
    p.add_argument("--engine", default="auto",
                   help="auto (platform/scene-aware) | megakernel | "
                        "wavefront | bvh | wavefront_bvh | fused | "
                        "wavefront_fused | tlas | sharded (the kernel "
                        "over every visible GPU) | adaptive (fused + "
                        "variance-guided per-pixel sample budgets)")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--frames", type=int, default=16,
                   help="progressive frames (1 spp each by default)")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--depth", type=int, default=20, help="max path depth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-jitter", action="store_true",
                   help="sample pixel centers (reference CPU/CUDA behavior)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: sample emissive lights "
                        "directly at diffuse hits (every engine; much "
                        "lower variance on emissive-lit scenes)")
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="thin-lens aperture radius in world units "
                        "(0 = pinhole, the reference behavior); enables "
                        "defocus blur in every engine")
    p.add_argument("--focus-distance", type=float, default=10.0,
                   help="focal-plane distance along the view direction "
                        "(with --lens-radius > 0)")
    p.add_argument("--rr-depth", type=int, default=0, metavar="D",
                   help="Russian roulette: stochastically terminate "
                        "low-throughput paths after D bounces, unbiased "
                        "(0 = off, the reference's fixed depth budget; "
                        "listed as future work in its wavefront.md)")
    p.add_argument("--clamp", type=float, default=0.0, metavar="C",
                   help="firefly clamp: cap per-sample radiance at C "
                        "before accumulation (0 = off; biased but kills "
                        "outlier speckle — reference wavefront.md future "
                        "work)")
    p.add_argument("--qmc", action="store_true",
                   help="QMC camera sampling: sub-pixel jitter and lens "
                        "aperture draw Cranley-Patterson-rotated Halton "
                        "points instead of independent uniforms (faster "
                        "AA/depth-of-field convergence; every engine)")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--look-at", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N iterations of the edge-aware a-trous "
                        "denoiser before the PNG encode (SVGF-style "
                        "guides from a one-bounce visibility pass; "
                        "postfx/denoise.py — an extension, the reference "
                        "displays raw MC accumulation)")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--out", default="render.png")
    p.add_argument("--hdr-out", default=None, metavar="PATH.pfm",
                   help="also write the linear HDR average as a Portable "
                        "Float Map (lossless float; the reference only "
                        "exposes its tonemapped u8 buffer)")
    p.add_argument("--checkpoint", default=None,
                   help="save film state here after rendering")
    p.add_argument("--resume", default=None,
                   help="load film state and continue accumulating")
    p.add_argument("--platform", default=None,
                   help="force the jax platform (cpu runs the jnp "
                        "engines only)")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage timing each frame (the ImGui "
                        "timing-graph analogue, main.cpp:265-462)")
    p.add_argument("--doctor", action="store_true",
                   help="probe platform/engines/native lib and exit (the "
                        "checkCUDA/checkOptiX analogue, main.cpp:46-83)")
    return p


def pick_engine(scene, platform: str) -> str:
    """--engine auto: the fused trace-kernel engine on a GPU (it matched
    or beat the segmented wavefront_fused end to end on every scene
    measured, PERF.md), the jnp engines elsewhere (the BVH traversal for
    triangle-heavy scenes, brute force otherwise)."""
    if platform == "gpu":
        return "fused"
    return "bvh" if scene.num_triangles > 512 else "megakernel"


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    if args.doctor:
        from parallelraytracing_tpu.utils.diagnostics import run_diagnostics
        results = run_diagnostics()
        return 0 if all(v["ok"] for v in results.values()) else 1
    render(args)
    return 0


def render(args) -> dict:
    """Render as the parsed arguments say; returns {engine, frames,
    first_frame_s, warm_ms_per_frame}."""
    import jax
    import numpy as np

    from parallelraytracing_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()

    from parallelraytracing_tpu import (Film, RenderConfig, Scene,
                                        ScenePreset, create_renderer)
    from parallelraytracing_tpu.core.camera import Camera, default_camera
    from parallelraytracing_tpu.utils.timing import FrameTimer

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, samples_per_frame=args.spp,
                       jitter=not args.no_jitter, seed=args.seed,
                       nee=args.nee, lens_radius=args.lens_radius,
                       focus_distance=args.focus_distance, qmc=args.qmc,
                       russian_roulette_depth=args.rr_depth,
                       firefly_clamp=args.clamp)

    if args.ply:
        from parallelraytracing_tpu.core.scene import ply_showcase_scene
        scene, default_eye, default_look = ply_showcase_scene(args.ply)
    elif args.mesh_level is not None:
        from parallelraytracing_tpu.core.scene import procedural_mesh_scene
        scene, default_eye, default_look = procedural_mesh_scene(
            args.mesh_level, args.seed)
    else:
        scene = Scene(ScenePreset(args.scene))
        default_eye = (5.0, 5.0, 8.0)  # main.cpp:142-150
        default_look = (0.0, 0.0, 0.0)

    eye = np.asarray(args.eye if args.eye is not None else default_eye,
                     np.float64)
    look = np.asarray(
        args.look_at if args.look_at is not None else default_look,
        np.float64)
    cam = Camera(eye, look - eye, float(args.width), float(args.height), 100.0)

    if args.resume:
        film, start_frame = Film.load_checkpoint(args.resume)
        assert film.width == args.width and film.height == args.height, \
            "checkpoint resolution mismatch"
        print(f"resumed from {args.resume} at frame {start_frame} "
              f"({film.sample_count} samples)")
    else:
        film = Film(args.width, args.height)
        start_frame = 0

    engine = args.engine
    if engine == "auto":
        engine = pick_engine(scene, jax.devices()[0].platform)

    renderer = create_renderer(engine)
    renderer.init(film, scene, cam, cfg)
    renderer._frame_index = start_frame

    timer = FrameTimer()
    dev = jax.devices()[0]
    scene_name = args.ply or (f"mesh-level-{args.mesh_level}"
                              if args.mesh_level is not None else args.scene)
    print(f"scene={scene_name} engine={engine} "
          f"{args.width}x{args.height} depth={cfg.max_depth} "
          f"prims={scene.num_primitives} device={dev.platform}:"
          f"{dev.device_kind} x{len(jax.devices())}")

    t_all = time.time()
    for i in range(args.frames):
        with timer.stage("render"):
            renderer.progressive_render()
            jax.block_until_ready(film.accum)
        if args.stats:
            print(f"frame {start_frame + i:4d}  "
                  f"render {timer.last('render')*1e3:8.1f} ms  "
                  f"fps {1.0 / max(timer.last('render'), 1e-9):6.1f}")
    total = time.time() - t_all
    first = timer.history("render")[0] if args.frames else 0.0
    warm = ((total - first) / (args.frames - 1) * 1e3
            if args.frames > 1 else float("nan"))
    print(f"{args.frames} frames in {total:.2f}s: first {first:.2f}s "
          f"(compile included), warm {warm:.2f} ms/frame, "
          f"{film.sample_count} samples accumulated")

    with timer.stage("tonemap"):
        if args.denoise > 0:
            from parallelraytracing_tpu.postfx import save_denoised_png
            save_denoised_png(args.out, film, scene.build(),
                              jax.numpy.asarray(cam.ray_params()), cfg,
                              iterations=args.denoise,
                              exposure=args.exposure, gamma=args.gamma)
        else:
            film.save_png(args.out, args.exposure, args.gamma)
    print(f"wrote {args.out}"
          + (f" (denoised x{args.denoise})" if args.denoise else ""))

    if args.hdr_out:
        film.save_pfm(args.hdr_out)
        print(f"wrote linear HDR {args.hdr_out}")

    if args.checkpoint:
        film.save_checkpoint(args.checkpoint,
                             frame_index=start_frame + args.frames)
        print(f"checkpointed film to {args.checkpoint}")

    if args.stats:
        print(timer.summary())
    return {"engine": engine, "frames": args.frames, "first_frame_s": first,
            "warm_ms_per_frame": warm}


if __name__ == "__main__":
    sys.exit(main())
