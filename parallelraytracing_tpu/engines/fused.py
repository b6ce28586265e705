"""Fused engine: a whole frame in one launch of the GPU trace kernel.

The performance engine for sphere and quad scenes: unlike the jnp
engines, whose per-bounce intermediates round-trip device memory, one
kernel launch traces every path from camera to termination with its
state in registers (ops/trace_kernel.py).

Camera rays are generated directly in Morton (Z-order) pixel order, so a
kernel block covers a compact screen tile and its warps walk the BVH
coherently.  The film stores accumulation in that same order
(film_layout), which moves the inverse permutation from every frame to
display time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu.engines.base import Renderer, register_engine
from parallelraytracing_tpu.ops.rays import frame_stream_seeds
from parallelraytracing_tpu.ops.trace_kernel import (check_platform,
                                                      pack_scene,
                                                      trace_paths)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "jitter", "lens"))
def raygen_ids(cam_params, ids, jseed, width: int, height: int,
               jitter: bool, lens=None, qpt=None):
    """Jitted raygen for an explicit pixel-id vector, with pixel-keyed
    jitter.  qpt: the sample's Halton point in QMC mode (ops/rays)."""
    from parallelraytracing_tpu.ops.rays import generate_camera_rays_ids
    return generate_camera_rays_ids(cam_params, width, height, ids, None,
                                    jitter, pix_seed=jseed, lens=lens,
                                    qpt=qpt)


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of v over 32 (x -> 0x0x0x... interleave)."""
    v = v.astype(np.uint64) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


@functools.lru_cache(maxsize=8)
def morton_pixel_perm(width: int, height: int):
    """(perm, inv) int32 arrays mapping scanline pixel order <-> Morton
    (Z-order) pixel order: perm[i] = pixel id at sorted position i,
    inv[p] = sorted position of pixel p.  Host-side, cached per
    resolution."""
    xx = _part1by1(np.arange(width, dtype=np.uint64))
    yy = _part1by1(np.arange(height, dtype=np.uint64)) << np.uint64(1)
    code = (yy[:, None] | xx[None, :]).reshape(-1)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


@register_engine
class FusedRenderer(Renderer):
    name = "fused"
    bake_instances = False

    #: run the kernel in Triton interpret mode (CPU tests); off, the
    #: engine refuses any platform but a CUDA GPU
    interpret: bool = False

    def _post_init(self) -> None:
        check_platform(self.interpret)
        self._pack_tables()
        cfg = self.config
        perm, inv = morton_pixel_perm(cfg.width, cfg.height)
        self._ids = jax.device_put(jnp.asarray(perm))
        self._minv = jnp.asarray(inv)

    def _pack_tables(self) -> None:
        self._tables = pack_scene(self._scene, self.config.nee)

    def film_layout(self):
        return self._minv, int(self._ids.shape[0])

    def render_sample_buffer(self, frame_index: int) -> jax.Array:
        return self._trace_ids(self._ids, frame_index)

    def _trace_ids(self, ids, frame_index: int) -> jax.Array:
        """One frame's mean radiance for an explicit pixel-id vector (in
        that order).  The full frame passes the Morton-ordered ids; the
        adaptive engine passes a selected subset.  A pixel's streams
        depend only on (pixel, frame), never on the selection."""
        cfg = self.config
        base = jax.random.fold_in(
            jax.random.PRNGKey(cfg.seed), jnp.uint32(frame_index))
        acc = None
        for s in range(cfg.samples_per_frame):
            skey = jax.random.fold_in(base, jnp.uint32(s))
            # the one shared seed derivation (ops/rays.frame_stream_seeds)
            # keeps fused == sharded == wavefront_fused bit for bit; raygen
            # stays its own jit, as in wavefront_fused, so XLA contracts
            # the thin-lens arithmetic identically in both engines
            jseed, s0 = frame_stream_seeds(skey)
            if cfg.qmc:
                jseed = self._qseed
            o, d = raygen_ids(self._cam_params, ids, jseed,
                              cfg.width, cfg.height, cfg.jitter, cfg.lens,
                              self._qpt(frame_index, s))
            rad = trace_frame(self._tables, o, d, ids, s0, cfg,
                              self.interpret)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame


#: the fused engine's trace step: every bounce of one sample in one jit
trace_frame = jax.jit(trace_paths, static_argnames=("cfg", "interpret"))
