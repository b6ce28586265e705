"""Multi-device rendering: shard_map over a ("px", "spp") device mesh.

The reference is strictly single-process single-GPU; its only parallel axis
is pixels within one device (SURVEY.md §2.4).  The scale-out axes for a
path tracer are:

- "px"  — spatial data parallelism: each chip generates and traces a
  contiguous block of pixels (the tile/grid analogue of
  cpu/renderer.cpp:20-33 and the CUDA launch grids, but across chips).
  The scene is replicated; no communication during tracing.
- "spp" — sample parallelism: chips render the SAME pixel block with
  different sample streams; the per-frame film contribution is their
  `psum`, which XLA hands to NCCL over NVLink — the multi-device
  generalization of Film::AddSampleBufferGPU (film.cu:79-99).

Both axes compose in one 2D mesh.  Radiance is psum'd over "spp", leaving
the frame sharded over "px"; the film can stay px-sharded, gathering only
for display.  Everything is `shard_map` + explicit collectives; every card
of an NVLink host reaches every other at the same rate, so the mesh
follows the algorithm alone (SURVEY.md §2.4, §5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.scene import SceneData
from parallelraytracing_tpu.engines.tracer import trace_paths_tiled
from parallelraytracing_tpu.ops.rays import generate_camera_rays_flat


def make_render_mesh(devices=None, spp_axis: Optional[int] = None) -> Mesh:
    """Build a ("px","spp") mesh. By default all devices go to the pixel
    axis (pure spatial DP); pass spp_axis>1 to split off sample
    parallelism."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    spp = spp_axis or 1
    assert n % spp == 0, f"{n} devices not divisible by spp axis {spp}"
    arr = np.array(devices).reshape(n // spp, spp)
    return Mesh(arr, axis_names=("px", "spp"))


def shard_block_size(cfg: RenderConfig, mesh: Mesh) -> int:
    """Pixels per px-shard (global pixel count padded up to the mesh)."""
    n_px = mesh.shape["px"]
    return -(-cfg.pixel_count // n_px)


def render_frame_sharded(
    scene: SceneData,
    cam_params: jax.Array,
    key: jax.Array,
    cfg: RenderConfig,
    mesh: Mesh,
    qpt: jax.Array | None = None,
) -> jax.Array:
    """One progressive frame over the mesh; NOT jitted itself — wrap in
    jax.jit (see render_frame_sharded_jit).

    Returns (H*W, 3) mean radiance over the mesh's spp axis x
    cfg.samples_per_frame samples, sharded over "px".

    qpt (QMC mode, cfg.qmc): the frame's Halton points as a
    (samples_per_frame, 4) f32 array (ops/rays.halton_qpt per sample) —
    the frame index lives host-side, so the caller supplies them."""
    blk = shard_block_size(cfg, mesh)
    n_spp = mesh.shape["spp"]
    r = cfg.pixel_count
    if cfg.qmc and qpt is None:
        raise ValueError("cfg.qmc requires the frame's Halton points "
                         "(qpt, one row per sample) — see halton_qpt")
    from parallelraytracing_tpu.ops.rays import qmc_rotation_seed
    qseed0 = (qmc_rotation_seed(cfg.seed).astype(jnp.int32)
              if cfg.qmc else None)

    def per_device(scene_rep, cam_rep, k, qpt_rep):
        px_i = jax.lax.axis_index("px")
        spp_i = jax.lax.axis_index("spp")
        start = px_i * blk
        dev_key = jax.random.fold_in(jax.random.fold_in(k, px_i), spp_i)

        def one_sample(s, acc):
            skey = jax.random.fold_in(dev_key, s)
            k_jit, k_path = jax.random.split(skey)
            if cfg.qmc:
                # Rotation seed is device-INDEPENDENT on the px axis
                # (pixel-keyed → layout-invariant) but distinct per spp
                # shard (each spp stream = its own rotated sequence).
                sstep = jnp.int32(0x632BE5AB)
                pseed = (qseed0 + spp_i.astype(jnp.int32)
                         * sstep).astype(jnp.uint32)
                o, d = generate_camera_rays_flat(
                    cam_rep, cfg.width, cfg.height, start, blk,
                    None, cfg.jitter, lens=cfg.lens,
                    pix_seed=pseed, qpt=qpt_rep[s])
            else:
                o, d = generate_camera_rays_flat(
                    cam_rep, cfg.width, cfg.height, start, blk,
                    k_jit, cfg.jitter, lens=cfg.lens)
            return acc + trace_paths_tiled(scene_rep, o, d, k_path, cfg)

        acc = jnp.zeros((blk, 3), jnp.float32)
        if cfg.samples_per_frame > 1:
            acc = jax.lax.fori_loop(0, cfg.samples_per_frame, one_sample, acc)
        else:
            acc = one_sample(0, acc)
        # Sum the sample streams across the "spp" axis.
        return jax.lax.psum(acc, axis_name="spp")

    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P("px", None),
        # The tracer's loop carries mix replicated inits with
        # device-varying ray state; skip the varying-manual-axes type
        # check rather than thread pvary through every carry.
        check_vma=False,
    )
    if qpt is None:
        qpt = jnp.zeros((cfg.samples_per_frame, 4), jnp.float32)
    out = shard(scene, cam_params, key, qpt)
    return out[:r] / (n_spp * cfg.samples_per_frame)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_frame_sharded_jit(scene, cam_params, key, cfg, mesh, qpt=None):
    return render_frame_sharded(scene, cam_params, key, cfg, mesh, qpt)


def render_frame_sharded_fused(tables, cam_params: jax.Array,
                               key: jax.Array, cfg: RenderConfig,
                               mesh: Mesh, interpret: bool = False,
                               perm: jax.Array | None = None,
                               qpt: jax.Array | None = None) -> jax.Array:
    """Multi-device frame through the trace kernel: each ("px","spp")
    device traces its pixel block with every bounce in one launch, and
    the sample streams are psum'd over "spp".  tables
    (ops/trace_kernel.SceneTables) replicate to every device.  perm: a
    pixel-id order of length n_px*blk (Morton order padded with
    out-of-range ids, so each device traces a coherent screen block;
    None = scanline order).  Returns the (n_px*blk, 3) frame in perm
    order (the film keeps that layout, so accumulation stays
    px-sharded).

    Determinism contract: the path and jitter seeds derive from the
    frame key only, the in-kernel RNG is keyed on global pixel ids, and
    jitter is pixel-keyed — so for a fixed spp-axis size the image is
    bit-invariant to device count, px-shard layout and perm, and with
    spp axis 1 it equals the fused engine's.  spp shard i draws sample
    stream i.  With the thin-lens aperture open XLA may contract the
    lens mul-adds differently inside shard_map, so isolated pixels can
    differ by about one ulp across device counts."""
    from parallelraytracing_tpu.ops.rays import (frame_stream_seeds,
                                                 generate_camera_rays_ids)
    from parallelraytracing_tpu.ops.trace_kernel import trace_paths

    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    blk = -(-cfg.pixel_count // n_px)
    if perm is None:  # scanline order; pad slots trace dummy rays
        perm = jnp.arange(n_px * blk, dtype=jnp.int32)
    assert perm.shape == (n_px * blk,), (perm.shape, n_px * blk)

    jseed0, seed0 = frame_stream_seeds(key)
    jseed0 = jseed0.astype(jnp.int32)  # spp-offset math below stays int32
    if cfg.qmc:
        # frame-independent rotation seed (the fused engine's, so the 1x1
        # contract holds) plus this sample's Halton point
        from parallelraytracing_tpu.ops.rays import qmc_rotation_seed
        if qpt is None:
            raise ValueError("cfg.qmc requires this sample's Halton "
                             "point (qpt) — see ops/rays.halton_qpt")
        jseed0 = qmc_rotation_seed(cfg.seed).astype(jnp.int32)

    def trace_block(t, cam, seed0, jseed0, ids, spp_i, qpt):
        # sample stream spp_i: odd-stride offsets of both seeds
        sstep = jnp.int32(0x632BE5AB)
        seed = seed0 + spp_i * sstep
        jseed = (jseed0 + spp_i * sstep).astype(jnp.uint32)
        ids = ids.reshape(-1)
        o, d = generate_camera_rays_ids(
            cam, cfg.width, cfg.height, ids, None, cfg.jitter,
            pix_seed=jseed, lens=cfg.lens, qpt=qpt)
        return trace_paths(t, o, d, ids, seed, cfg, interpret)

    if n_px == 1 and n_spp == 1:
        # 1x1 mesh: the streams are device-count independent, so skipping
        # shard_map + psum gives the bit-identical image
        return trace_block(tables, cam_params, seed0, jseed0, perm,
                           jnp.int32(0), qpt)
    if qpt is None:
        qpt = jnp.zeros((4,), jnp.float32)  # unused (non-QMC)

    def per_device(t, cam, seed0, jseed0, ids, qpt):
        spp_i = jax.lax.axis_index("spp").astype(jnp.int32)
        rad = trace_block(t, cam, seed0, jseed0, ids, spp_i, qpt)
        return jax.lax.psum(rad, axis_name="spp")

    shard = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("px"), P()),
        out_specs=P("px", None),
        check_vma=False)
    return shard(tables, cam_params, seed0, jseed0, perm, qpt) / n_spp
