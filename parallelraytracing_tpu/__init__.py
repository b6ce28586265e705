"""parallelraytracing_tpu — a progressive Monte Carlo path tracer in JAX.

A JAX/XLA framework, with a Pallas (Triton) trace kernel for NVIDIA
GPUs, with the capabilities of the CUDA/OptiX reference renderer
(Rickyeeeeee/ParallelRayTracing): sphere/quad/triangle
geometry, four analytic BSDFs (Lambertian, metal, dielectric, emissive),
seven preset scenes, PLY mesh loading, an accumulating film with Reinhard
tonemapping + gamma, an interactive orbit camera, and multiple
interchangeable rendering engines:

- ``megakernel``  — one fused jit program per frame (the analogue of the
  reference's CUDA megakernel, src/backend/cuda_megakernel/renderer.cu).
- ``wavefront``   — staged per-bounce kernels over a fixed-capacity SoA ray
  pool with sort-based stream compaction (the analogue of the reference's
  CUDA wavefront queues, src/backend/cuda_wavefront/renderer.cu — sort-
  based compaction replaces warp-aggregated atomic queue pushes).
- ``bvh``         — LBVH (Morton codes + binary radix tree) with stackless
  threaded traversal (the analogue of the reference's OptiX backend,
  src/backend/optix/renderer.cpp).
- ``fused`` / ``wavefront_fused`` / ``sharded`` / ``adaptive`` — the GPU
  trace kernel (ops/trace_kernel.py): one lane per path, state in
  registers across bounces.

Everything on the compute path is pure JAX (jnp + lax + Pallas); scenes are
flat struct-of-array jnp buffers, not pointer graphs; the whole bounce loop
stays inside one jit so there is no per-bounce host sync (the reference's
own stated design goal, wavefront.md:28-36).
"""

__version__ = "0.1.0"

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.camera import Camera
from parallelraytracing_tpu.core.film import Film
from parallelraytracing_tpu.core.scene import Scene, ScenePreset, SceneData
from parallelraytracing_tpu.engines import create_renderer, available_engines

__all__ = [
    "RenderConfig",
    "Camera",
    "Film",
    "Scene",
    "SceneData",
    "ScenePreset",
    "create_renderer",
    "available_engines",
    "__version__",
]
