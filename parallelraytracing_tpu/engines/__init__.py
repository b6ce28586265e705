"""Rendering engines (the reference's four swappable backends,
src/core/renderer.h:8-16 + src/backend/*)."""

from parallelraytracing_tpu.engines.base import (
    Renderer, available_engines, create_renderer, register_engine)

# Importing registers each engine.
from parallelraytracing_tpu.engines import (  # noqa: F401
    adaptive, bvh, fused, megakernel, sharded, tlas, wavefront,
    wavefront_fused)

__all__ = ["Renderer", "available_engines", "create_renderer",
           "register_engine"]
