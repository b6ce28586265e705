"""Oracle gates: the kernel engines against the jnp megakernel oracle.

The megakernel engine replicates the reference's geometry, BSDF and
tonemap semantics formula by formula; it is the plain reference every
other engine is checked against.  The kernel engines draw their own PCG
streams, so their agreement with it is statistical: converged HDR
averages (64x48, 4096 spp by default) must agree to RMSE < 1e-3, where
both sides' Monte Carlo noise has fallen below the gate.  Exact checks
apply where the code promises them:

- fused == wavefront_fused, bit for bit (the RNG is keyed on pixel and
  absolute depth, so compaction and re-sorting cannot change the image);
- bvh == megakernel on equal threefry streams, up to the f32 rounding of
  t in two traversal orders, which flips a rare knife-edge dielectric
  choice: fewer than 1% of pixels may differ by more than 1e-3.

The oracle runs under jax.default_matmul_precision("highest"), so no
reduced-precision matmul can enter the reference on any platform.
bench.py and chip_smoke.py run these gates; tests run them at a tiny
size for their shape.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import numpy as np

#: HDR RMSE bound of the statistical gates
GATE_RMSE = 1.0e-3
#: equal-streams bound: share of pixels allowed to differ by > 1e-3
GATE_FLIP_SHARE = 0.01


def render_hdr(engine: str, scene, cam, cfg, spp: int,
               interpret: bool = False) -> np.ndarray:
    """(H, W, 3) HDR average of `spp` samples of one engine."""
    from parallelraytracing_tpu import Film, create_renderer
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a trace-kernel engine
        r.interpret = interpret
    r.init(film, scene, cam, cfg)
    for _ in range(max(1, spp // cfg.samples_per_frame)):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def oracle_hdr(scene, cam, cfg, spp: int) -> np.ndarray:
    with jax.default_matmul_precision("highest"):
        return render_hdr("megakernel", scene, cam, cfg, spp)


def mesh_gate_scene():
    """A sky-lit procedural mesh (1,280 triangles) on a ground quad."""
    from parallelraytracing_tpu import Scene
    from parallelraytracing_tpu.core.mesh import icosphere
    s = Scene(preset=None)
    body = s.add_lambertian((0.7, 0.6, 0.45))
    s.add_mesh(icosphere(3, seed=1), body, ((6, 6, 6), (0, 0, 0), (0, 6, 0)))
    ground = s.add_lambertian((0.5, 0.5, 0.52))
    s.add_quad(120, 120, ground, None)
    return s


def instanced_gate_scene(baked: bool):
    """Four instances of two procedural meshes; baked=True adds the same
    geometry as world-space triangles (what the oracle traces)."""
    from parallelraytracing_tpu import Scene
    from parallelraytracing_tpu.core.mesh import icosphere
    ico = icosphere(1, seed=2)
    s = Scene(preset=None)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    blue = s.add_lambertian((0.2, 0.3, 0.8))
    tfs = [(red, ((2.0,) * 3, (0, 30 * i, 0), (-4 + 4 * i, 2, 0)))
           for i in range(3)]
    tfs.append((blue, ((1.5,) * 3, (0, 15, 25), (0, 2, 5))))
    for mid, tf in tfs:
        if baked:
            s.add_mesh(ico, mid, tf)
        else:
            s.add_mesh_instances(ico, mid, [tf])
    ground = s.add_lambertian((0.5, 0.5, 0.52))
    s.add_quad(60, 60, ground, None)
    return s


def textured_gate_scene():
    """A sky-lit image-textured quad over a ground quad."""
    from parallelraytracing_tpu import Scene
    yy, xx = np.mgrid[0:16, 0:16]
    img16 = np.stack([(xx % 8) / 7.0, (yy % 8) / 7.0,
                      ((xx + yy) % 16) / 15.0], axis=-1)
    s = Scene(preset=None)
    tm = s.add_textured_lambertian(s.add_texture(img16))
    s.add_quad(6, 6, tm, ((1, 1, 1), (60, 0, 0), (0, 4, -4)))
    g = s.add_lambertian((0.5, 0.5, 0.52))
    s.add_quad(40, 40, g, None)
    return s


def run_gates(spp: int = 4096, width: int = 64, height: int = 48,
              interpret: bool = False,
              log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Run every gate; returns {name: {..., "pass": bool}} with an
    overall "pass" entry.  interpret runs the kernel in Triton interpret
    mode (CPU tests only)."""
    from parallelraytracing_tpu import RenderConfig, Scene, ScenePreset
    from parallelraytracing_tpu.core.camera import Camera

    def cam(eye, look):
        eye = np.asarray(eye, np.float64)
        return Camera(eye, np.asarray(look, np.float64) - eye,
                      float(width), float(height), 100.0)

    cfg = RenderConfig(width=width, height=height, max_depth=10, seed=0,
                       samples_per_frame=min(32, spp))
    out: Dict[str, dict] = {}

    def record(name, ok, **kw):
        out[name] = {"pass": bool(ok), **kw}
        log(f"gate {name:34s} {'pass' if ok else 'FAIL'} "
            + " ".join(f"{k}={v}" for k, v in kw.items()))

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    def statistical(name, engine, scene_fn, camera, n_spp, oracle_fn=None):
        img = render_hdr(engine, scene_fn(), camera, cfg, n_spp, interpret)
        ref = oracle_hdr((oracle_fn or scene_fn)(), camera, cfg, n_spp)
        e = rmse(img, ref)
        record(name, np.isfinite(img).all() and e < GATE_RMSE, rmse=e,
               spp=n_spp, bound=GATE_RMSE)

    mt = lambda: Scene(ScenePreset.MATERIAL_TEST)
    mt_cam = cam((5.0, 5.0, 8.0), (0.0, 0.0, 0.0))
    statistical("material_test fused~oracle", "fused", mt, mt_cam, spp)

    few = min(spp, 32)
    fcfg = cfg.replace(samples_per_frame=1)
    a = render_hdr("fused", mt(), mt_cam, fcfg, 4, interpret)
    b = render_hdr("wavefront_fused", mt(), mt_cam, fcfg, 4, interpret)
    record("material_test fused==wavefront_fused",
           np.array_equal(a, b), max_abs_diff=float(np.abs(a - b).max()),
           spp=4)

    with jax.default_matmul_precision("highest"):
        o32 = render_hdr("megakernel", mt(), mt_cam, fcfg, few)
        b32 = render_hdr("bvh", mt(), mt_cam, fcfg, few)
    flips = float((np.abs(o32 - b32).max(-1) > 1e-3).mean())
    record("material_test bvh==megakernel", flips < GATE_FLIP_SHARE,
           flip_share=flips, rmse=rmse(o32, b32), spp=few,
           bound=GATE_FLIP_SHARE)

    statistical("procedural mesh fused~oracle", "fused", mesh_gate_scene,
                cam((0.0, 14.0, 28.0), (0.0, 7.0, 0.0)), spp)
    # instanced scenes vary more (small bright-edged instances): twice the
    # samples keep the MC floor well under the gate
    statistical("instances fused~baked oracle", "fused",
                lambda: instanced_gate_scene(False),
                cam((0.0, 6.0, 16.0), (0.0, 2.0, 0.0)), 2 * spp,
                oracle_fn=lambda: instanced_gate_scene(True))
    statistical("textured quad fused~oracle", "fused", textured_gate_scene,
                cam((0.0, 5.0, 10.0), (0.0, 3.0, 0.0)), spp)
    out["pass"] = all(v["pass"] for v in out.values())
    return out
