"""Megakernel engine: the full bounce loop in one fused jit per frame.

The analogue of the reference's CUDA megakernel backend
(src/backend/cuda_megakernel/renderer.cu:132-173: one thread = one pixel =
full path).  A frame is two dispatches: a tiny camera-raygen jit and the
path-trace jit holding the whole bounce loop (dispatch overhead is
microseconds; keeping raygen in a separate XLA program keeps the jittered
threefry raygen graph out of the while-loop's compile).
RNG is counter-based threefry keyed on (seed, frame, sample) — the pattern
of the OptiX backend's per-frame PCG seeds (device_programs.cu:169) rather
than persistent curand state."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.scene import SceneData
from parallelraytracing_tpu.engines.base import Renderer, register_engine
from parallelraytracing_tpu.engines.tracer import trace_paths_tiled
from parallelraytracing_tpu.ops.rays import generate_camera_rays


@partial(jax.jit, static_argnames=("width", "height", "jitter", "lens"))
def raygen(cam_params: jax.Array, key: jax.Array, width: int, height: int,
           jitter: bool, lens=None, pix_seed=None, qpt=None):
    """Shared jnp-engine raygen.  pix_seed/qpt enable QMC camera sampling
    (cfg.qmc — pixel-keyed Cranley–Patterson rotation of the sample's
    Halton point, ops/rays)."""
    return generate_camera_rays(cam_params, width, height, key, jitter,
                                lens=lens, pix_seed=pix_seed, qpt=qpt)


@partial(jax.jit, static_argnames=("cfg",))
def trace(scene: SceneData, o: jax.Array, d: jax.Array, key: jax.Array,
          cfg: RenderConfig, lights=None) -> jax.Array:
    return trace_paths_tiled(scene, o, d, key, cfg, lights=lights)


@partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene: SceneData, cam_params: jax.Array, key: jax.Array,
                 cfg: RenderConfig) -> jax.Array:
    """Single-program frame render (raygen + trace fused). Used by tooling
    that wants one jittable fn; the engine's hot loop uses the two-phase
    dispatch above (see module docstring)."""

    def one_sample(s, acc):
        skey = jax.random.fold_in(key, s)
        k_jit, k_path = jax.random.split(skey)
        o, d = generate_camera_rays(cam_params, cfg.width, cfg.height,
                                    k_jit, cfg.jitter, lens=cfg.lens)
        return acc + trace_paths_tiled(scene, o, d, k_path, cfg)

    acc = jnp.zeros((cfg.pixel_count, 3), jnp.float32)
    if cfg.samples_per_frame == 1:
        acc = one_sample(0, acc)
    else:
        acc = jax.lax.fori_loop(0, cfg.samples_per_frame, one_sample, acc)
    return acc / cfg.samples_per_frame


@register_engine
class MegakernelRenderer(Renderer):
    name = "megakernel"

    def _post_init(self) -> None:
        from parallelraytracing_tpu.ops.nee import extract_lights
        self._lights = (extract_lights(jax.device_get(self._scene_data))
                        if self.config.nee else None)

    def render_sample_buffer(self, frame_index: int) -> jax.Array:
        cfg = self.config
        base = jax.random.fold_in(
            jax.random.PRNGKey(cfg.seed), jnp.uint32(frame_index))
        acc = None
        for s in range(cfg.samples_per_frame):
            skey = jax.random.fold_in(base, jnp.uint32(s))
            k_jit, k_path = jax.random.split(skey)
            o, d = raygen(self._cam_params, k_jit, cfg.width, cfg.height,
                          cfg.jitter, cfg.lens, self._qseed,
                          self._qpt(frame_index, s))
            rad = trace(self._scene_data, o, d, k_path, cfg,
                        self._lights)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
