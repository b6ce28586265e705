"""Sharded engine: the GPU trace kernel over every visible device.

A ("px","spp") `jax.sharding.Mesh` over all devices; each device traces
its pixel block through the same kernel, and sample streams are
`psum`-reduced over the "spp" axis (NVLink/NCCL between cards,
parallel/sharding.render_frame_sharded_fused).  On one device it
degenerates to a 1x1 mesh and costs what the fused engine costs.

Determinism: the per-frame path and jitter seeds derive from the frame
key only, the in-kernel RNG is keyed on global pixel ids, and jitter is
pixel-keyed — so for a fixed spp-axis size the image is bit-invariant to
the device count and the pixel-shard layout, and with spp_axis 1 it
equals the fused engine's image (tests/test_trace_kernel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu.engines.base import register_engine
from parallelraytracing_tpu.engines.fused import (FusedRenderer,
                                                  morton_pixel_perm)


@register_engine
class ShardedRenderer(FusedRenderer):
    name = "sharded"

    #: devices on the sample axis (the rest go to the pixel axis)
    spp_axis: int = 1

    #: explicit device list for the mesh (None = all visible devices)
    devices = None

    def film_layout(self):
        return self._sinv, int(self._sperm.shape[0])

    def _post_init(self) -> None:
        from parallelraytracing_tpu.parallel.sharding import (
            make_render_mesh, render_frame_sharded_fused)

        super()._post_init()

        devs = (list(self.devices) if self.devices is not None
                else list(jax.devices()))
        spp = (self.spp_axis
               if self.spp_axis >= 1 and len(devs) % self.spp_axis == 0
               else 1)
        mesh = self._mesh = make_render_mesh(devs, spp_axis=spp)

        # Morton-ordered pixel ids so each device's block is a coherent
        # screen region; pad slots get out-of-range ids (dummy rays the
        # film never reads)
        cfg = self.config
        n_px = mesh.shape["px"]
        r = cfg.pixel_count
        blk = -(-r // n_px)
        mperm, minv = morton_pixel_perm(cfg.width, cfg.height)
        self._sperm = jnp.asarray(np.concatenate(
            [mperm, np.arange(r, n_px * blk)]).astype(np.int32))
        self._sinv = jnp.asarray(minv)
        interpret = self.interpret

        @jax.jit
        def _frame(tables, cam, key, perm, qpt=None):
            return render_frame_sharded_fused(
                tables, cam, key, cfg, mesh, interpret=interpret,
                perm=perm, qpt=qpt)

        self._frame_fn = _frame

    def render_sample_buffer(self, frame_index: int) -> jax.Array:
        cfg = self.config
        base = jax.random.fold_in(
            jax.random.PRNGKey(cfg.seed), jnp.uint32(frame_index))
        acc = None
        for s in range(cfg.samples_per_frame):
            key = jax.random.fold_in(base, jnp.uint32(s))
            rad = self._frame_fn(self._tables, self._cam_params, key,
                                 self._sperm, self._qpt(frame_index, s))
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
