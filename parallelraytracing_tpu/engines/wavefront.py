"""Wavefront engine: staged per-bounce kernels over a compacted ray pool.

The analogue of the reference's CUDA wavefront backend
(src/backend/cuda_wavefront/renderer.cu): per-pixel PixelState SoA arrays
persisting across bounces (renderer.h:9-33), per-bounce
intersect -> shade stages (renderer.cu:206-335), and ray queues that keep
work proportional to *alive* rays.

Translation of each piece:

- Warp-aggregated atomic queue pushes (renderer.cu:43-100) become a
  deterministic compaction: a cumsum prefix-sum
  scatter: pos = cumsum(alive)-1; queue[pos] = ray_index — O(R), stable,
  and deterministic.
- The reference launches full-screen-sized grids every bounce regardless of
  queue size and flags it as waste (wavefront.md:60-67); here the bounce
  processes ceil(alive/T) tiles via a fori_loop with a *traced* trip count
  — the literal queue-size-proportional launch the reference never built.
- The early-exit the reference disabled to avoid device->host sync
  (renderer.cu:422-425) is free here: the while_loop condition
  (count > 0) stays on device.
- RNG is pixel-keyed (unit vectors / uniforms generated per bounce and
  gathered by pixel id), so results are invariant to queue order and
  bit-match the megakernel engine at equal seed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.scene import MAT_LAMBERTIAN, SceneData
from parallelraytracing_tpu.engines.base import Renderer, register_engine
from parallelraytracing_tpu.engines.megakernel import raygen
from parallelraytracing_tpu.ops.intersect import intersect_scene
from parallelraytracing_tpu.ops.materials import (
    emitted, random_unit_vectors, scatter)
from parallelraytracing_tpu.ops.nee import sample_light


@partial(jax.jit, static_argnames=("cfg", "use_bvh"))
def wavefront_trace(scene: SceneData, o: jax.Array, d: jax.Array,
                    key: jax.Array, cfg: RenderConfig,
                    bvh=None, use_bvh: bool = False,
                    lights=None) -> jax.Array:
    """Trace R camera rays through the staged wavefront loop.

    Pool state lives in R-sized SoA arrays (pixel index == pool slot, like
    the reference's PixelStateSOA); the queue holds alive pixel indices
    compacted to the front.

    With `lights` (ops/nee.LightsData), every Lambertian vertex also
    samples one emissive primitive directly — the shadow ray runs the
    same per-tile intersector as the bounce ray, so NEE composes with
    both the brute-force and the BVH variants (the jnp tracer's
    semantics, engines/tracer.py)."""
    r = o.shape[0]
    tile = min(cfg.ray_tile, r)
    n_pad = (-r) % tile
    rp = r + n_pad
    if n_pad:
        o = jnp.pad(o, ((0, n_pad), (0, 0)))
        d = jnp.pad(d, ((0, n_pad), (0, 0)), constant_values=1.0)

    radiance = jnp.zeros((rp, 3), jnp.float32)
    throughput = jnp.ones((rp, 3), jnp.float32)
    queue = jnp.arange(rp, dtype=jnp.int32)
    count = jnp.int32(r)  # padding rays start dead
    # NEE bookkeeping: emission at a vertex reached by a diffuse bounce is
    # owned by the previous vertex's light sample (no double counting).
    no_emit = jnp.zeros((rp,), bool)

    def bounce_cond(state):
        depth, count, *_ = state
        return (depth < cfg.max_depth) & (count > 0)

    def intersect(ot, dt):
        # IntersectClosestKernel analogue (renderer.cu:206-272). With
        # use_bvh the tile traverses the LBVH: the queue keeps tiles
        # dense with alive rays, so the traversal's lockstep worst case
        # is bounded per tile, not per pool.
        if use_bvh:
            from parallelraytracing_tpu.accel.traverse import \
                bvh_intersect_scene
            return bvh_intersect_scene(scene, bvh, ot, dt, cfg.t_min,
                                       cfg.t_max)
        return intersect_scene(scene, ot, dt, cfg.t_min, cfg.t_max,
                               cfg.intersect_chunk)

    def bounce(state):
        depth, count, queue, o, d, radiance, throughput, no_emit = state

        # Per-bounce pixel-keyed randomness (threefry counters replace the
        # reference's per-pixel curand states, renderer.cu:166-176).
        k = jax.random.fold_in(key, depth)
        k_dir, k_uni = jax.random.split(k)
        unit_all = random_unit_vectors(k_dir, rp)
        uni_all = jax.random.uniform(k_uni, (rp,), dtype=jnp.float32)
        if lights is not None:
            k_nee = jax.random.fold_in(k, 11)
            u3_all = jax.random.uniform(k_nee, (rp, 3), dtype=jnp.float32)
        if cfg.russian_roulette_depth > 0:
            # Same derivation (fold_in(k, 7), per pool slot) as the jnp
            # tracer's single-tile path (n_tiles==1 in trace_paths_tiled),
            # so the engines draw identical survival uniforms whenever the
            # tracer runs un-tiled; multi-tile tracer runs fold the key per
            # tile and only agree statistically.
            k_rr = jax.random.fold_in(k, 7)
            u_rr_all = jax.random.uniform(k_rr, (rp,), dtype=jnp.float32)

        n_tiles = (count + tile - 1) // tile

        def tile_body(i, carry):
            o, d, radiance, throughput, alive_pool, no_emit = carry
            idx = jax.lax.dynamic_slice(queue, (i * tile,), (tile,))
            lane = jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)[:, 0]
            in_queue = (i * tile + lane) < count
            safe = jnp.where(in_queue, idx, 0)

            ot = o[safe]
            dt = d[safe]
            thr = throughput[safe]

            hit = intersect(ot, dt)

            # --- ShadeHitsKernel analogue (renderer.cu:274-335)
            miss = in_queue & ~hit.hit
            lit = in_queue & hit.hit
            from parallelraytracing_tpu.ops.sky import sky_radiance
            add = jnp.where(miss[:, None], thr * sky_radiance(scene, dt),
                            0.0)
            emit_ok = lit & ~no_emit[safe]
            add = add + jnp.where(emit_ok[:, None],
                                  thr * emitted(scene, hit.mat), 0.0)

            new_d, atten, scat_alive = scatter(
                scene, dt, hit, unit_all[safe], uni_all[safe])
            cont = lit & scat_alive

            is_lam = scene.mat_type[hit.mat] == MAT_LAMBERTIAN
            if lights is not None:
                # --- next-event estimation (tracer.py semantics): one
                # light sample + shadow ray per Lambertian vertex.
                wi, pdf, lvalid, lkind, lidx, lemit = sample_light(
                    lights, hit.pos, u3_all[safe])
                cos_s = jnp.sum(hit.normal * wi, axis=1)
                cand = lit & is_lam & lvalid & (cos_s > 0.0)
                sh = intersect(hit.pos, wi)
                vis = sh.hit & (sh.kind == lkind) & (sh.idx == lidx)
                # Texture-aware albedo (ops/materials.surface_albedo — the
                # single albedo source shared with the scatter estimator);
                # the raw material color would silently untexture NEE's
                # direct term on checker / image-textured surfaces.
                from parallelraytracing_tpu.ops.materials import \
                    surface_albedo
                albedo = surface_albedo(scene, hit)
                w = (cos_s / (jnp.pi * jnp.maximum(pdf, 1e-12)))[:, None]
                add = add + jnp.where((cand & vis)[:, None],
                                      thr * albedo * w * lemit, 0.0)

            thr_new = thr * atten
            if cfg.russian_roulette_depth > 0:
                # Russian roulette (tracer.py semantics, bit-matching
                # streams): survival prob = max channel of the post-
                # attenuation throughput, applied from rr_depth on.
                p = jnp.clip(jnp.max(thr_new, axis=1), 0.05, 1.0)
                roulette = depth >= cfg.russian_roulette_depth
                survive = ~roulette | (u_rr_all[safe] < p)
                thr_new = jnp.where((cont & roulette & survive)[:, None],
                                    thr_new / p[:, None], thr_new)
                cont = cont & survive

            # Scatter-update pool state; masked lanes dropped via an
            # out-of-bounds index (mode="drop").
            widx = jnp.where(in_queue, safe, rp)
            radiance = radiance.at[widx].add(add, mode="drop")
            cidx = jnp.where(cont, safe, rp)
            throughput = throughput.at[cidx].set(thr_new, mode="drop")
            o = o.at[cidx].set(hit.pos, mode="drop")
            d = d.at[cidx].set(new_d, mode="drop")
            if lights is not None:
                no_emit = no_emit.at[cidx].set(is_lam, mode="drop")
            dead = in_queue & ~cont
            alive_pool = alive_pool.at[jnp.where(dead, safe, rp)].set(
                False, mode="drop")
            return o, d, radiance, throughput, alive_pool, no_emit

        # Alive flags for rays currently in the queue.
        alive_pool = jnp.zeros((rp,), bool).at[
            jnp.where(jnp.arange(rp) < count, queue, rp)].set(
                True, mode="drop")

        (o, d, radiance, throughput, alive_pool, no_emit) = \
            jax.lax.fori_loop(
                0, n_tiles, tile_body,
                (o, d, radiance, throughput, alive_pool, no_emit))

        # --- queue compaction (replaces nextRayQueue atomic pushes):
        # stable prefix-sum scatter of surviving pixel ids.
        pos = jnp.cumsum(alive_pool.astype(jnp.int32)) - 1
        new_count = pos[-1] + 1
        src = jnp.arange(rp, dtype=jnp.int32)
        new_queue = jnp.zeros((rp,), jnp.int32).at[
            jnp.where(alive_pool, pos, rp)].set(src, mode="drop")

        return (depth + 1, new_count, new_queue, o, d, radiance,
                throughput, no_emit)

    state = (jnp.int32(0), count, queue, o, d, radiance, throughput,
             no_emit)
    state = jax.lax.while_loop(bounce_cond, bounce, state)
    return state[5][:r]


@register_engine
class WavefrontRenderer(Renderer):
    name = "wavefront"
    use_bvh = False

    def _post_init(self) -> None:
        from parallelraytracing_tpu.ops.nee import extract_lights
        self._bvh = None
        if self.use_bvh:
            from parallelraytracing_tpu.accel.lbvh import build_bvh
            self._bvh = jax.device_put(build_bvh(self._scene_data))
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
            rad = wavefront_trace(self._scene_data, o, d, k_path, cfg,
                                  self._bvh, self.use_bvh, self._lights)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame


@register_engine
class WavefrontBVHRenderer(WavefrontRenderer):
    """Wavefront loop over LBVH traversal — the OptiX-wavefront analogue:
    compacted queues + acceleration structure."""

    name = "wavefront_bvh"
    use_bvh = True
