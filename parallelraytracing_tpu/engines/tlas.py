"""TLAS engines: two-level (instance) BVH traversal.

The analogue of the reference's OptiX IAS-over-GAS pipeline
(optix/renderer.cpp:833-870): unique meshes keep ONE local-space BLAS,
instances are transform records, and rays traverse TLAS -> BLAS with an
inverse-transform at instance entry.  Geometry memory is proportional to
unique meshes (Scene.add_mesh_instances does not duplicate triangles).

Two registrations:

- `tlas` — the fast path: the fused engine, whose GPU trace kernel
  traces instances natively (in-kernel TLAS/BLAS, ops/trace_kernel.py).
  Registered separately so "render instanced scenes through the
  two-level structure" is an explicit, discoverable engine choice.
- `tlas_ref` — the jnp gather-based mirror (accel/tlas.py traversal
  inside the megakernel loop).  Kept as the test oracle: it shares the
  jnp engines' threefry RNG streams, so instancing correctness is
  checkable at float tolerance instead of Monte-Carlo tolerance
  (tests/test_tlas.py)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.accel.lbvh import BVHData, build_bvh
from parallelraytracing_tpu.accel.tlas import (TwoLevelBVH, resolve_instanced_hit,
                                               tlas_intersect)
from parallelraytracing_tpu.accel.traverse import bvh_intersect_scene
from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.scene import KIND_TRIANGLE, SceneData
from parallelraytracing_tpu.engines.base import Renderer, register_engine
from parallelraytracing_tpu.engines.fused import FusedRenderer
from parallelraytracing_tpu.engines.megakernel import raygen
from parallelraytracing_tpu.engines.tracer import trace_paths_tiled
from parallelraytracing_tpu.ops.intersect import HitRecord

_BIG = 3.0e38


def combined_intersect(scene: SceneData, bvh: BVHData, tl: TwoLevelBVH,
                       o: jax.Array, d: jax.Array, t_min: float,
                       t_max: float) -> HitRecord:
    """Closest hit across the base scene's LBVH and the instance TLAS."""
    base = bvh_intersect_scene(scene, bvh, o, d, t_min, t_max)
    t2, inst, tri, b1, b2 = tlas_intersect(tl, o, d, t_min, t_max)
    pos2, n2, front2, mat2 = resolve_instanced_hit(tl, o, d, t2, inst, tri,
                                                   b1, b2)
    better = t2 < jnp.where(base.hit, base.t, _BIG)
    bb = better[:, None]
    # Image-textured scenes carry a uv channel; instanced meshes don't
    # store per-vertex uvs, so instanced hits sample the texture origin
    # (the engine refuses image textures + instances at init — see
    # TlasRenderer._post_init).
    uv = (None if base.uv is None
          else jnp.where(bb, 0.0, base.uv))
    return HitRecord(
        t=jnp.where(better, t2, base.t),
        hit=base.hit | better,
        pos=jnp.where(bb, pos2, base.pos),
        normal=jnp.where(bb, n2, base.normal),
        front=jnp.where(better, front2, base.front),
        mat=jnp.where(better, mat2, base.mat),
        kind=jnp.where(better, jnp.int32(KIND_TRIANGLE), base.kind),
        idx=jnp.where(better, tri, base.idx),
        uv=uv,
    )


@partial(jax.jit, static_argnames=("cfg",))
def tlas_trace(scene: SceneData, bvh: BVHData, tl: TwoLevelBVH,
               o: jax.Array, d: jax.Array, key: jax.Array,
               cfg: RenderConfig, lights=None) -> jax.Array:
    def intersect(s, oo, dd):
        return combined_intersect(s, bvh, tl, oo, dd, cfg.t_min, cfg.t_max)

    return trace_paths_tiled(scene, o, d, key, cfg, intersect,
                             lights=lights)


@register_engine
class TLASRenderer(FusedRenderer):
    """The fast two-level path: the fused engine's trace kernel with
    its in-kernel TLAS/BLAS (instances traced natively in mesh-local
    space)."""

    name = "tlas"


@register_engine
class TLASRefRenderer(Renderer):
    """jnp mirror (test oracle) — see module docstring."""

    name = "tlas_ref"

    def _post_init(self) -> None:
        from parallelraytracing_tpu.ops.nee import extract_lights
        if (self._scene.instances
                and any(t >= 2 for t in self._scene._mat_tex)):
            raise NotImplementedError(
                "image textures on instanced-mesh scenes: instances do "
                "not carry per-vertex uvs (bake the mesh with add_mesh, "
                "or use add_checker — position-based, instance-safe)")
        base, tl = self._scene.build_two_level()
        self._scene_data = jax.device_put(base)  # base EXCLUDES instances
        self._bvh = jax.device_put(build_bvh(base))
        # Without instances this degrades to the plain single-level bvh
        # engine (diagnostics probe every engine on a preset scene).
        self._tlas = jax.device_put(tl) if tl is not None else None
        # NEE lights come from the base scene: instanced triangle meshes
        # are not samplable emitters (ops/nee.extract_lights enumerates
        # sphere/quad emissives), matching the other jnp engines.
        self._lights = (extract_lights(jax.device_get(base))
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
            if self._tlas is None:
                from parallelraytracing_tpu.engines.bvh import bvh_trace
                rad = bvh_trace(self._scene_data, self._bvh, o, d, k_path,
                                cfg, self._lights)
            else:
                rad = tlas_trace(self._scene_data, self._bvh, self._tlas,
                                 o, d, k_path, cfg, self._lights)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
