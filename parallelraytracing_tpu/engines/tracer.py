"""Shared iterative path-trace loop.

The JAX form of the reference's iterative radiance/throughput loop
(TraceRayGPU, cuda_megakernel/renderer.cu:81-119): the whole bounce loop is
a `lax.while_loop` inside one jit — no per-bounce host sync, the same
design goal the reference states for its wavefront loop
(wavefront.md:28-36, renderer.cu:422-425).

Faithful semantics:
- emission is added (scaled by throughput) on every hit BEFORE the scatter
  test (cpu/renderer.cpp:72-75, cuda_wavefront/renderer.cu:294-313);
- sky radiance is added (scaled by throughput) on miss, then the path dies
  (cuda_megakernel/renderer.cu:98-101);
- emissive materials terminate the path (material.h:119-122);
- depth budget `max_depth` (20 by default).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.scene import MAT_LAMBERTIAN, SceneData
from parallelraytracing_tpu.ops.intersect import HitRecord, intersect_scene
from parallelraytracing_tpu.ops.materials import (
    emitted, random_unit_vectors, scatter)
from parallelraytracing_tpu.ops.nee import LightsData, sample_light

IntersectFn = Callable[[SceneData, jax.Array, jax.Array], HitRecord]


def make_brute_force_intersector(cfg: RenderConfig) -> IntersectFn:
    def f(scene, o, d):
        return intersect_scene(scene, o, d, cfg.t_min, cfg.t_max,
                               cfg.intersect_chunk)
    return f


def trace_paths(
    scene: SceneData,
    o: jax.Array,          # (R,3)
    d: jax.Array,          # (R,3) unit
    key: jax.Array,
    cfg: RenderConfig,
    intersect: Optional[IntersectFn] = None,
    lights: Optional[LightsData] = None,
) -> jax.Array:
    """Path-trace R rays to completion; returns (R,3) radiance.

    With `lights` (and cfg.nee), every Lambertian vertex also samples one
    emissive primitive directly (ops/nee.py) and emission is skipped at
    vertices reached by a diffuse bounce — same expectation, much lower
    variance on emissive-lit scenes."""
    if intersect is None:
        intersect = make_brute_force_intersector(cfg)
    r = o.shape[0]
    radiance = jnp.zeros((r, 3), o.dtype)
    throughput = jnp.ones((r, 3), o.dtype)
    alive = jnp.ones((r,), bool)
    no_emit = jnp.zeros((r,), bool)

    def cond(state):
        depth, _, _, _, _, alive, _ = state
        return (depth < cfg.max_depth) & jnp.any(alive)

    def body(state):
        depth, o, d, radiance, throughput, alive, no_emit = state
        hit = intersect(scene, o, d)

        miss = alive & ~hit.hit
        from parallelraytracing_tpu.ops.sky import sky_radiance
        radiance = radiance + jnp.where(
            miss[:, None], throughput * sky_radiance(scene, d), 0.0)

        lit = alive & hit.hit
        radiance = radiance + jnp.where(
            (lit & ~no_emit)[:, None],
            throughput * emitted(scene, hit.mat), 0.0)

        k = jax.random.fold_in(key, depth)
        k_dir, k_uni = jax.random.split(k)
        unit = random_unit_vectors(k_dir, r)
        uni = jax.random.uniform(k_uni, (r,), dtype=o.dtype)
        new_d, atten, scat_alive = scatter(scene, d, hit, unit, uni)

        is_lam = scene.mat_type[hit.mat] == MAT_LAMBERTIAN
        if lights is not None:
            # --- next-event estimation at Lambertian vertices
            k_nee = jax.random.fold_in(k, 11)
            u3 = jax.random.uniform(k_nee, (r, 3), dtype=o.dtype)
            wi, pdf, lvalid, lkind, lidx, lemit = sample_light(
                lights, hit.pos, u3)
            cos_s = jnp.sum(hit.normal * wi, axis=1)
            cand = lit & is_lam & lvalid & (cos_s > 0.0)
            sh = intersect(scene, hit.pos, wi)
            vis = sh.hit & (sh.kind == lkind) & (sh.idx == lidx)
            from parallelraytracing_tpu.ops.materials import surface_albedo
            albedo = surface_albedo(scene, hit)
            w = (cos_s / (jnp.pi * jnp.maximum(pdf, 1e-12)))[:, None]
            contrib = throughput * albedo * w * lemit
            radiance = radiance + jnp.where(
                (cand & vis)[:, None], contrib, 0.0)

        cont = lit & scat_alive
        throughput = jnp.where(cont[:, None], throughput * atten, throughput)

        if cfg.russian_roulette_depth > 0:
            # Improvement over the reference (listed as future work,
            # wavefront.md:91-96): survival prob = max channel throughput.
            p = jnp.clip(jnp.max(throughput, axis=1), 0.05, 1.0)
            k_rr = jax.random.fold_in(k, 7)
            u_rr = jax.random.uniform(k_rr, (r,), dtype=o.dtype)
            roulette = depth >= cfg.russian_roulette_depth
            survive = ~roulette | (u_rr < p)
            throughput = jnp.where(
                (cont & roulette & survive)[:, None], throughput / p[:, None],
                throughput)
            cont = cont & survive

        o = jnp.where(cont[:, None], hit.pos, o)
        d = jnp.where(cont[:, None], new_d, d)
        # Emission at the next vertex is already accounted by this
        # vertex's light sample iff the bounce was diffuse.
        no_emit_next = (cont & is_lam) if lights is not None \
            else jnp.zeros_like(cont)
        return depth + 1, o, d, radiance, throughput, cont, no_emit_next

    state = (jnp.int32(0), o, d, radiance, throughput, alive, no_emit)
    state = jax.lax.while_loop(cond, body, state)
    return state[3]


def count_bounce_rays(scene: SceneData, cam_params: jax.Array,
                      key: jax.Array, cfg: RenderConfig) -> float:
    """Total rays actually traced in one frame (camera rays + rays still
    alive at each bounce) — the quantity the Mrays/s benchmark divides by
    wall time.  Runs the same bounce loop with an alive-count accumulator."""
    from parallelraytracing_tpu.ops.rays import generate_camera_rays

    intersect = make_brute_force_intersector(cfg)

    @partial(jax.jit, static_argnames=())
    def _count(scene, o, d, key):
        r = o.shape[0]
        alive = jnp.ones((r,), bool)
        throughput = jnp.ones((r, 3), o.dtype)

        def body(state):
            depth, o, d, alive, count = state
            count = count + jnp.sum(alive.astype(jnp.int32))
            hit = intersect(scene, o, d)
            k = jax.random.fold_in(key, depth)
            k_dir, k_uni = jax.random.split(k)
            unit = random_unit_vectors(k_dir, r)
            uni = jax.random.uniform(k_uni, (r,), dtype=o.dtype)
            new_d, _, scat_alive = scatter(scene, d, hit, unit, uni)
            cont = alive & hit.hit & scat_alive
            o = jnp.where(cont[:, None], hit.pos, o)
            d = jnp.where(cont[:, None], new_d, d)
            return depth + 1, o, d, cont, count

        def cond(state):
            depth, _, _, alive, _ = state
            return (depth < cfg.max_depth) & jnp.any(alive)

        state = (jnp.int32(0), o, d, alive, jnp.int32(0))
        state = jax.lax.while_loop(cond, body, state)
        return state[4]

    o, d = generate_camera_rays(cam_params, cfg.width, cfg.height, None,
                                False)
    total = 0
    tile = min(cfg.ray_tile, o.shape[0])
    n = o.shape[0]
    for s in range(0, n, tile):
        e = min(s + tile, n)
        ot = jnp.pad(o[s:e], ((0, tile - (e - s)), (0, 0)))
        dt = jnp.pad(d[s:e], ((0, tile - (e - s)), (0, 0)),
                     constant_values=1.0)
        c = int(_count(scene, ot, dt, jax.random.fold_in(key, s)))
        if e - s < tile:
            c = int(c * (e - s) / tile)  # padded dummy rays pro-rated
        total += c
    return float(total)


def trace_paths_tiled(
    scene: SceneData,
    o: jax.Array,
    d: jax.Array,
    key: jax.Array,
    cfg: RenderConfig,
    intersect: Optional[IntersectFn] = None,
    lights: Optional[LightsData] = None,
) -> jax.Array:
    """Tile rays so the (rays x chunk) intersection transients stay small,
    then run the bounce loop per tile (tiles are sequential via lax.map —
    the XLA analogue of launching grid blocks)."""
    r = o.shape[0]
    tile = min(cfg.ray_tile, r)
    n_pad = (-r) % tile
    if n_pad:
        o = jnp.pad(o, ((0, n_pad), (0, 0)))
        d = jnp.pad(d, ((0, n_pad), (0, 0)), constant_values=1.0)
    n_tiles = (r + n_pad) // tile
    if n_tiles == 1:
        return trace_paths(scene, o, d, key, cfg, intersect, lights)[:r]

    o_t = o.reshape(n_tiles, tile, 3)
    d_t = d.reshape(n_tiles, tile, 3)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.arange(n_tiles, dtype=jnp.uint32))

    def one(args):
        ot, dt, kt = args
        return trace_paths(scene, ot, dt, kt, cfg, intersect, lights)

    out = jax.lax.map(one, (o_t, d_t, keys))
    return out.reshape(n_tiles * tile, 3)[:r]
