"""Wavefront-fused engine: kernel segments with queue compaction between.

The reference's wavefront architecture (cuda_wavefront/renderer.cu:
372-434) on the GPU trace kernel:

- trace a segment of bounces in one kernel launch (ray state stays in
  registers inside the segment);
- between segments, compact dead rays out and re-sort the survivors by
  direction octant and the Morton code of their origin (one argsort and
  one stacked row gather), so the next segment's blocks are full and
  their warps coherent — sorting as the divergence fix the reference
  lists as future work (wavefront.md:45-120);
- the RNG is keyed on (pixel id, absolute depth), so compaction and
  sorting cannot change the image: it equals the fused engine's bit for
  bit (tests/test_trace_kernel.py).

Finished radiance rides the ray state and is scattered into the
pixel-indexed frame once, at the end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.engines.base import Renderer, register_engine
from parallelraytracing_tpu.engines.fused import (morton_pixel_perm,
                                                  raygen_ids)
from parallelraytracing_tpu.ops.rays import frame_stream_seeds
from parallelraytracing_tpu.ops.trace_kernel import (check_platform,
                                                      pack_scene, padded,
                                                      ray_planes,
                                                      trace_segment)

#: bounces per segment; the last entry repeats until max_depth.  The
#: first compaction lands after bounce 2, when the rays that left the
#: scene are gone.
SCHEDULE = (2, 4, 14)


def _part1by2(v: jax.Array) -> jax.Array:
    """Spread 10 bits over 30 (jnp int32, in-jit)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & jnp.int32(0x030000FF)
    v = (v | (v << 8)) & jnp.int32(0x0300F00F)
    v = (v | (v << 4)) & jnp.int32(0x030C30C3)
    v = (v | (v << 2)) & jnp.int32(0x09249249)
    return v


def _sort_key(state, bb_lo, inv_ext, mode: str):
    """Coherence key for the between-segment re-sort: "origin" is the
    30-bit Morton code of the scene-box-quantized ray origin; "octant"
    puts the direction octant (3 bits) above 27 origin bits."""
    def q(o, lo, ie):
        return jnp.clip((o - lo) * ie * 1024.0, 0.0, 1023.0).astype(jnp.int32)
    m = (_part1by2(q(state[0], bb_lo[0], inv_ext[0])) << 2) \
        | (_part1by2(q(state[1], bb_lo[1], inv_ext[1])) << 1) \
        | _part1by2(q(state[2], bb_lo[2], inv_ext[2]))
    if mode == "origin":
        return m
    oct_ = ((state[3] < 0).astype(jnp.int32) << 2) \
        | ((state[4] < 0).astype(jnp.int32) << 1) \
        | (state[5] < 0).astype(jnp.int32)
    return (oct_ << 27) | (m >> 3)


def segment_lengths(schedule: tuple, max_depth: int) -> list:
    """Per-segment bounce counts covering max_depth (the last entry of
    schedule repeats)."""
    out = []
    k = 0
    while sum(out) < max_depth:
        s = schedule[min(k, len(schedule) - 1)]
        out.append(min(int(s), max_depth - sum(out)))
        k += 1
    return out


def _compact(order, pix, state):
    """Permute the queue by `order` with one stacked row gather (pixel
    ids ride as f32 bit patterns)."""
    mat = jnp.take(jnp.stack(
        [jax.lax.bitcast_convert_type(pix, jnp.float32), *state], axis=1),
        order, axis=0)
    return (jax.lax.bitcast_convert_type(mat[:, 0], jnp.int32),
            [mat[:, k + 1] for k in range(13)])


@partial(jax.jit, static_argnames=("cfg", "interpret", "sort_rays",
                                   "schedule"))
def segmented_trace(tables, o, d, pix, seed, cfg: RenderConfig,
                    interpret: bool = False, sort_rays: str = "octant",
                    schedule: tuple = SCHEDULE):
    """(R, 3) radiance of camera rays (o, d), indexed by their pixel ids
    pix (int32; rays may arrive in any order, e.g. Morton order)."""
    r = o.shape[0]
    rp = padded(r)
    pix = jnp.pad(pix, (0, rp - r))  # pad slots are dead: slot >= count
    count = jnp.int32(r)
    state = ray_planes(o, d)
    bb_lo, inv_ext = tables.bb
    depth0 = 0
    segs = segment_lengths(schedule, cfg.max_depth)
    for s, n in enumerate(segs):
        state = list(trace_segment(tables, pix, state, seed, depth0, count,
                                   n, cfg, interpret))
        depth0 += n
        if s + 1 < len(segs):
            alive = state[12] > 0.0
            key = (_sort_key(state, bb_lo, inv_ext, sort_rays) if sort_rays
                   else jnp.arange(rp, dtype=jnp.int32))
            order = jnp.argsort(jnp.where(alive, key, jnp.int32(2 ** 30)))
            count = jnp.sum(alive.astype(jnp.int32))
            pix, state = _compact(order, pix, state)
    # dead slots carry zero radiance, so their scatter adds nothing
    return jnp.zeros((r, 3), jnp.float32).at[pix].add(
        jnp.stack(state[9:12], axis=1))


@partial(jax.jit, static_argnames=("cfg", "interpret"))
def count_frame_rays(tables, o, d, pix, seed, cfg: RenderConfig,
                     interpret: bool = False) -> jax.Array:
    """Exact ray count of one frame: camera rays plus the rays alive
    entering every later bounce, by stepping the same pixel-keyed
    streams the kernel engines trace in one-bounce segments."""
    r = o.shape[0]
    rp = padded(r)
    pix = jnp.pad(pix, (0, rp - r))
    state = ray_planes(o, d)
    count = jnp.int32(r)
    total = jnp.int32(0)
    for depth in range(cfg.max_depth):
        total = total + count
        state = list(trace_segment(tables, pix, state, seed, depth, count,
                                   1, cfg, interpret))
        alive = state[12] > 0.0
        order = jnp.argsort(jnp.where(alive, jnp.arange(rp, dtype=jnp.int32),
                                      jnp.int32(2 ** 30)))
        count = jnp.sum(alive.astype(jnp.int32))
        pix, state = _compact(order, pix, state)
    return total


@register_engine
class WavefrontFusedRenderer(Renderer):
    name = "wavefront_fused"
    bake_instances = False

    #: Triton interpret mode (CPU tests); see FusedRenderer.interpret
    interpret: bool = False
    #: bounces per segment (last entry repeats)
    schedule: tuple = SCHEDULE
    #: between-segment re-sort key: "octant", "origin" or "" (compact only)
    sort_rays: str = "octant"

    def _post_init(self) -> None:
        check_platform(self.interpret)
        self._tables = pack_scene(self._scene, self.config.nee)
        cfg = self.config
        perm, _ = morton_pixel_perm(cfg.width, cfg.height)
        self._perm = jax.device_put(jnp.asarray(perm))

    def render_sample_buffer(self, frame_index: int) -> jax.Array:
        cfg = self.config
        base = jax.random.fold_in(
            jax.random.PRNGKey(cfg.seed), jnp.uint32(frame_index))
        acc = None
        for s in range(cfg.samples_per_frame):
            skey = jax.random.fold_in(base, jnp.uint32(s))
            # Morton-ordered camera rays, pixel-keyed jitter, the shared
            # seed derivation (ops/rays.frame_stream_seeds)
            jseed, s0 = frame_stream_seeds(skey)
            if cfg.qmc:
                jseed = self._qseed
            o, d = raygen_ids(self._cam_params, self._perm, jseed,
                              cfg.width, cfg.height, cfg.jitter, cfg.lens,
                              self._qpt(frame_index, s))
            rad = segmented_trace(self._tables, o, d, self._perm, s0, cfg,
                                  self.interpret, self.sort_rays,
                                  tuple(self.schedule))
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
