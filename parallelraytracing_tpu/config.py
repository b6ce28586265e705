"""Run-time configuration for the renderer.

The reference has no config system at all — everything is a hardcoded
constant scattered across backends (depth 20/20/10, sky (0.4,0.3,0.6)
duplicated in four places, window 1920x1080, tMin 0.001; see
/root/reference/src/backend/cpu/renderer.h:31-34,
/root/reference/src/backend/cuda_wavefront/renderer.cu:404-407,
/root/reference/src/backend/optix/renderer.h:119).  Here those constants
live in one dataclass, overridable from the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Self-intersection epsilon: the reference relies on a ray tMin instead of
# offsetting scatter origins ("CPU REPLICA: No origin offset, relies on
# tMin" — /root/reference/src/backend/optix/device_programs.cu:100,116,148;
# constant at /root/reference/src/core/shape.h:128).
SHAPE_RAY_T_MIN = 1.0e-3

# Sky radiance added (scaled by throughput) when a ray escapes the scene
# (/root/reference/src/backend/cuda_megakernel/renderer.cu:159).
DEFAULT_SKY = (0.4, 0.3, 0.6)

# The reference camera hardcodes a vertical FoV of 1 radian
# (tanFovY = tan(0.5), /root/reference/src/core/camera.h:111).
TAN_HALF_FOV_Y = 0.5  # tan() of this is taken at camera-ray time


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings. Frozen + hashable so it can be a jit static arg."""

    width: int = 1920
    height: int = 1080
    # Path depth budget. Reference: 20 for CPU/megakernel/wavefront
    # (cpu/renderer.h:34, cuda_wavefront/renderer.cu:407), 10 for OptiX
    # (optix/renderer.h:119). Default 20.
    max_depth: int = 20
    # Samples per pixel per progressive frame (reference is always 1;
    # batching >1 spp per frame amortizes per-frame dispatch).
    samples_per_frame: int = 1
    # Pixel jitter for anti-aliasing. The reference's OptiX backend jitters
    # (device_programs.cu:172-173) while CPU/megakernel/wavefront sample
    # pixel centers. Default on, matching the highest-quality backend.
    jitter: bool = True
    # Monte Carlo seed. Reference uses time-seeded curand / frame-hashed PCG;
    # we use counter-based threefry so frames are reproducible.
    seed: int = 0
    # Ray tMin (self-intersection epsilon).
    t_min: float = SHAPE_RAY_T_MIN
    t_max: float = 1.0e16
    # Number of primitives processed per inner chunk in the brute-force
    # intersector (bounds the (rays x prims) working set).
    intersect_chunk: int = 256
    # Rays per tile: the bounce loop runs tile-by-tile (lax.map) so the
    # transient (rays x chunk) intersection matrices stay within HBM.
    ray_tile: int = 1 << 17
    # Wavefront engine: compact the ray pool (sort alive rays to the front
    # and halve the active region) whenever the live fraction drops below
    # this threshold. 0 disables compaction.
    compaction_threshold: float = 0.5
    # Accumulate/compute dtype for radiance. f32 is the fidelity reference;
    # bf16 throughput mode may be added per-engine.
    dtype: str = "float32"

    # Russian roulette: terminate low-throughput paths stochastically after
    # this depth (0 disables — the reference has none; listed as future work
    # in wavefront.md:91-96).
    russian_roulette_depth: int = 0

    #: Next-event estimation (direct light sampling at diffuse vertices,
    #: ops/nee.py) — an extension over the reference; off for fidelity.
    nee: bool = False
    # Firefly clamping: cap per-sample radiance before accumulation
    # (0 disables; biased but kills outlier speckle — wavefront.md lists it
    # as planned future work).
    firefly_clamp: float = 0.0

    # Thin-lens depth of field (extension — every reference camera is
    # pinhole, camera.h:104-132): aperture radius and focus distance in
    # world units.  0 radius = pinhole, bit-identical to before.
    lens_radius: float = 0.0
    focus_distance: float = 10.0

    #: QMC camera sampling (extension — every reference backend is plain
    #: MC): the sub-pixel jitter and thin-lens aperture draw
    #: Cranley–Patterson-rotated Halton points (bases 2,3 / 5,7) instead
    #: of independent uniforms, so each pixel's camera samples over the
    #: progressive frames form a low-discrepancy sequence (ops/rays
    #: halton_qpt / qmc_rotation_seed).  Path-vertex sampling stays MC.
    qmc: bool = False

    @property
    def lens(self) -> Optional[Tuple[float, float]]:
        """(radius, focus_distance) for ops.rays raygen, or None when the
        aperture is closed (the static pinhole fast path)."""
        if self.lens_radius > 0.0:
            return (self.lens_radius, self.focus_distance)
        return None

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DisplayConfig:
    """Tonemap/display settings (reference Film::UpdateDisplay defaults,
    /root/reference/src/core/film.h:33-34)."""

    exposure: float = 1.0
    gamma: float = 2.2
