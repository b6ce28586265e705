"""Startup capability probes and graceful degradation.

The analogue of the reference's checkCUDA()/checkOptiX() probes
(main.cpp:46-83) and its register-only-if-available backend policy
(main.cpp:162-163): probe the accelerator, each engine, and the native
library, reporting status so callers can pick working engines instead of
crashing mid-frame."""

from __future__ import annotations

import time
import traceback
from typing import Dict, List


def run_diagnostics(verbose: bool = True) -> Dict[str, dict]:
    """Probe platform + engines on a 16x8 scene. Returns {name: status}."""
    results: Dict[str, dict] = {}

    def record(name, ok, detail="", ms=None):
        results[name] = {"ok": bool(ok), "detail": str(detail),
                         "ms": None if ms is None else round(ms, 1)}
        if verbose:
            mark = "OK " if ok else "FAIL"
            extra = f" ({ms:.0f} ms)" if ms is not None else ""
            print(f"[{mark}] {name:24s} {detail}{extra}")

    # Platform
    try:
        import jax
        dev = jax.devices()[0]
        record("platform", True, f"{dev.platform}: {dev}")
    except Exception as e:
        record("platform", False, repr(e))
        return results

    # Tiny dispatch round-trip
    try:
        import jax.numpy as jnp
        import numpy as np
        t0 = time.perf_counter()
        v = float(np.asarray(jax.jit(lambda x: x * 2 + 1)(jnp.ones((8, 128))).sum()))
        record("dispatch", v == 3072.0, "jit round-trip",
               (time.perf_counter() - t0) * 1e3)
    except Exception as e:
        record("dispatch", False, repr(e))

    # Native library
    try:
        from parallelraytracing_tpu import native
        record("native", native.available(),
               "_native.so" if native.available()
               else "not built (make -C native); using Python fallbacks")
    except Exception as e:
        record("native", False, repr(e))

    # Engines
    from parallelraytracing_tpu import (Film, RenderConfig, Scene,
                                        ScenePreset, available_engines,
                                        create_renderer)
    from parallelraytracing_tpu.core.camera import default_camera

    cfg = RenderConfig(width=16, height=8, max_depth=3, seed=0,
                       intersect_chunk=8, ray_tile=1 << 10)
    import jax
    on_gpu = jax.devices()[0].platform == "gpu"
    needs_gpu = []
    for name in available_engines():
        try:
            scene = Scene(ScenePreset.MATERIAL_TEST)
            film = Film(cfg.width, cfg.height)
            r = create_renderer(name)
            if hasattr(r, "interpret") and not on_gpu:
                needs_gpu.append(name)  # a trace-kernel engine
                continue
            t0 = time.perf_counter()
            r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
            r.progressive_render()
            jax.block_until_ready(film.accum)
            import numpy as np
            img = np.asarray(film.hdr_average())
            ok = bool(np.isfinite(img).all() and img.max() > 0)
            record(f"engine:{name}", ok, "rendered",
                   (time.perf_counter() - t0) * 1e3)
        except Exception as e:
            record(f"engine:{name}", False,
                   f"{type(e).__name__}: {str(e)[:120]}")
    if needs_gpu:
        record("kernel engines", True,
               f"{', '.join(needs_gpu)}: not probed, they need a CUDA GPU "
               f"(platform is {jax.devices()[0].platform})")

    return results


def working_engines() -> List[str]:
    """Names of engines that pass the probe (for UI registries)."""
    res = run_diagnostics(verbose=False)
    return sorted(k.split(":", 1)[1] for k, v in res.items()
                  if k.startswith("engine:") and v["ok"])
