#!/usr/bin/env python
"""Benchmark: ray throughput on the reference's headline workload, the
mesh workloads and the oracle gates, on one GPU.

Headline (the reference defaults, SURVEY.md §6): RANDOM_BALLS_LARGE (809
primitives), 1920x1080, 1 spp per progressive frame, max depth 20, in
two camera views.  Mrays/s counts every ray traced (camera rays plus the
rays alive entering each later bounce) over the steady-state wall time
per frame.  The kernel engines' count is exact: it steps the same
pixel-keyed streams they trace (count_frame_rays).

Prints one JSON line with the full record, then a compact summary as the
last line.  Exits 4 if an oracle gate fails, and non-zero if an engine
fails or no GPU is found.

Env knobs: BENCH_WIDTH/HEIGHT/DEPTH/FRAMES/PRESET/ENGINE,
BENCH_WORKLOADS=headline (skip the mesh rows), BENCH_FIDELITY=0 (skip
the gates), BENCH_FIDELITY_SPP.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _compact_summary(rec: dict) -> dict:
    """The headline, the gates' verdict and each workload's Mrays/s."""
    detail = rec["detail"]
    return {
        "metric": rec["metric"], "value": rec["value"], "unit": rec["unit"],
        "detail": {
            "engine": detail["engine"],
            "device": detail["device"],
            "fidelity_pass": detail["fidelity"].get("pass"),
            "workloads_mrays": {tag: w["mrays"]
                                for tag, w in detail["workloads"].items()},
        },
    }


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from parallelraytracing_tpu import (Film, RenderConfig, Scene,
                                        ScenePreset, create_renderer)
    from parallelraytracing_tpu.core.camera import Camera
    from parallelraytracing_tpu.core.mesh import icosphere
    from parallelraytracing_tpu.core.scene import procedural_mesh_scene
    from parallelraytracing_tpu.engines.tracer import count_bounce_rays
    from parallelraytracing_tpu.utils.compile_cache import \
        enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a CUDA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "count": len(jax.devices()), "card": _card()}
    print(f"# {device}", file=sys.stderr)

    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    depth = int(os.environ.get("BENCH_DEPTH", 20))
    frames = int(os.environ.get("BENCH_FRAMES", 8))
    preset = ScenePreset(os.environ.get("BENCH_PRESET", "random_balls_large"))
    engine = os.environ.get("BENCH_ENGINE", "fused")

    def camera(eye, look, w, h):
        eye = np.asarray(eye, np.float64)
        return Camera(eye, np.asarray(look, np.float64) - eye, float(w),
                      float(h), 100.0)

    def exact_ray_count(r, cfg, n_frames=3) -> float:
        """Average rays/frame of the kernel engines: steps the same
        pixel-keyed PCG streams they trace, one bounce per segment."""
        from parallelraytracing_tpu.engines.wavefront_fused import \
            count_frame_rays
        from parallelraytracing_tpu.ops.rays import (
            frame_stream_seeds, generate_camera_rays_ids)
        total = 0
        ids = jnp.arange(cfg.pixel_count, dtype=jnp.int32)
        for f in range(n_frames):
            base = jax.random.fold_in(
                jax.random.PRNGKey(cfg.seed), jnp.uint32(f))
            skey = jax.random.fold_in(base, jnp.uint32(0))
            # pixel-keyed streams: scanline ids replay Morton-order traces
            jseed, s0 = frame_stream_seeds(skey)
            o, d = generate_camera_rays_ids(
                r._cam_params, cfg.width, cfg.height, ids, None,
                cfg.jitter, pix_seed=jseed)
            total += int(count_frame_rays(r._tables, o, d, ids, s0, cfg))
        return total / n_frames

    def measure(name, scene, cam, cfg, n_frames):
        """Steady-state ms/frame and Mrays/s of one engine."""
        film = Film(cfg.width, cfg.height)
        r = create_renderer(name)
        r.init(film, scene, cam, cfg)
        r.progressive_render()  # compile
        jax.block_until_ready(film.accum)
        if hasattr(r, "_tables"):
            rays_per_frame = exact_ray_count(r, cfg)
            count_method = "exact_kernel_pcg"
        else:
            rays_per_frame = count_bounce_rays(
                r._scene_data, r._cam_params, jax.random.PRNGKey(123), cfg)
            count_method = "jnp_threefry_estimate"
        t0 = time.perf_counter()
        for _ in range(n_frames):
            r.progressive_render()
        jax.block_until_ready(film.accum)
        dt = (time.perf_counter() - t0) / n_frames
        return {
            "engine": name,
            "mrays": rays_per_frame / dt / 1e6,
            "rays_per_frame": int(rays_per_frame),
            "ms_per_frame": dt * 1000.0,
            # 1 spp per frame: spp/s = frames/s
            "spp_per_sec": cfg.samples_per_frame / dt,
            "ray_count_method": count_method,
            "resolution": f"{cfg.width}x{cfg.height}",
            "max_depth": cfg.max_depth,
        }

    cfg = RenderConfig(width=width, height=height, max_depth=depth, seed=0)
    scene = Scene(preset)
    # The reference's default camera (eye (5,5,8) -> origin,
    # main.cpp:142-150) is the headline; the elevated overview shows the
    # whole 809-primitive field (longer mean path).
    views = {
        "reference_default": measure(
            engine, scene, camera((5.0, 5.0, 8.0), (0, 0, 0), width, height),
            cfg, frames),
        "overview": measure(
            engine, scene,
            camera((30.0, 18.0, 30.0), (0, 0, 0), width, height), cfg,
            frames),
    }

    # ---- mesh workloads: seeded procedural meshes (core/mesh.icosphere)
    # through the segmented kernel engine and its in-kernel TLAS/BLAS
    workloads = {}
    if os.environ.get("BENCH_WORKLOADS", "all") != "headline":
        def multimesh_scene():
            small = icosphere(1, seed=2)
            big = icosphere(5, seed=1)
            s = Scene(preset=None)
            body = s.add_lambertian((0.7, 0.6, 0.45))
            s.add_mesh_instances(
                big, body, [((6, 6, 6), (0, 160, 0), (0, 6, 0)),
                            ((3, 3, 3), (0, 40, 0), (-12, 3, 6))])
            glass = s.add_dielectric(1.5)
            red = s.add_lambertian((0.8, 0.15, 0.1))
            s.add_mesh_instances(
                small, glass, [((2.5,) * 3, (0, 30 * i, 0),
                                (9 + 2.5 * i, 2.5, 8 - 3.0 * i))
                               for i in range(3)])
            s.add_mesh_instances(
                small, red, [((2,) * 3, (0, 15, 25), (-9, 2, 12)),
                             ((1.5,) * 3, (30, 0, 0), (4, 1.5, 14))])
            ground = s.add_lambertian((0.5, 0.5, 0.52))
            s.add_quad(120, 120, ground, None)
            light = s.add_emissive((11, 11, 10))
            s.add_sphere(3.5, light, ((1, 1, 1), (0, 0, 0), (14, 26, 14)))
            return s, (0.0, 12.0, 30.0), (0.0, 5.0, 0.0)

        half_w, half_h = width // 2, height // 2
        full = cfg
        half = cfg.replace(width=half_w, height=half_h,
                           max_depth=min(8, depth))
        rows = {
            # level 5: 20,480 triangles
            "mesh_20k_1080p_d20": (lambda: procedural_mesh_scene(5), full),
            "mesh_20k_1080p_d20_rr2": (
                lambda: procedural_mesh_scene(5),
                full.replace(russian_roulette_depth=2)),
            "multimesh_tlas_halfres_d8": (multimesh_scene, half),
            "multimesh_tlas_1080p_d8": (
                multimesh_scene, full.replace(max_depth=min(8, depth))),
            # level 7: 327,680 triangles; level 8: 1,310,720
            "mesh_320k_halfres_d8": (lambda: procedural_mesh_scene(7), half),
            "mesh_1280k_halfres_d8": (lambda: procedural_mesh_scene(8),
                                      half),
        }
        for tag, (build, wcfg) in rows.items():
            s, eye, look = build()
            workloads[tag] = measure(
                "wavefront_fused", s,
                camera(eye, look, wcfg.width, wcfg.height), wcfg,
                max(2, frames // 2))

    fidelity = {}
    if os.environ.get("BENCH_FIDELITY", "1") != "0":
        from parallelraytracing_tpu.utils.fidelity import run_gates
        fidelity = run_gates(
            spp=int(os.environ.get("BENCH_FIDELITY_SPP", "4096")),
            log=lambda s: print("# " + s, file=sys.stderr))

    hl = views["reference_default"]
    record = {
        "metric": "Mrays_per_sec_per_chip",
        "value": hl["mrays"],
        "unit": "Mrays/s",
        "detail": {
            "engine": engine,
            "preset": preset.value,
            "resolution": f"{width}x{height}",
            "max_depth": depth,
            "camera": "reference_default (eye (5,5,8), main.cpp:142-150)",
            "views": views,
            "workloads": workloads,
            "fidelity": fidelity,
            "device": device,
        },
    }
    print(json.dumps(record))
    print(json.dumps(_compact_summary(record)))
    return 4 if fidelity and not fidelity["pass"] else 0


if __name__ == "__main__":
    sys.exit(main())
