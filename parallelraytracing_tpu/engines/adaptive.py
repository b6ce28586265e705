"""Adaptive sampling: variance-guided per-pixel sample budgets.

An extension with no reference analogue (every reference backend traces
every pixel every frame, film.cu:57-99) — and a natural fit for how this
framework already works:

- the fused engine's raygen/trace path takes an EXPLICIT pixel-id
  vector (engines/fused.raygen_ids), so "sample these pixels" is the
  same kernel as "sample all pixels", over fewer rays;
- the per-frame budget is STATIC (a fixed fraction of the frame,
  rounded to ray tiles), so one XLA program serves every frame — the
  selection changes as data, via jax.lax.top_k over the per-pixel
  error estimate;
- the film's per-pixel weights already make non-uniform coverage exact
  (each pixel's value is the mean of its own samples), so no extra
  normalization pass exists.

Loop: `warmup` full frames seed a per-pixel luminance mean/variance
(Welford via raw sums, in film-storage order), then each frame traces
only the `budget` fraction of pixels with the largest relative standard
error of the mean  sqrt(var/n) / (mean + eps)  — the standard adaptive
MC stopping heuristic.  RNG streams are keyed on (pixel, frame) exactly
as in the fused engine, so a pixel's samples are independent of WHICH
frames happened to select it, and the warmup frames are bit-identical
to the fused engine's.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallelraytracing_tpu.engines.base import register_engine
from parallelraytracing_tpu.engines.fused import FusedRenderer
from parallelraytracing_tpu.ops.trace_kernel import BLOCK


@partial(jax.jit, static_argnames=("budget",))
def _select_slots(m1, m2, n, valid, budget: int):
    """Top-`budget` storage slots by relative standard error of the mean,
    returned ASCENDING so the subset keeps the Morton coherence of the
    underlying slot order."""
    mean = m1 / jnp.maximum(n, 1.0)
    var = jnp.maximum(m2 / jnp.maximum(n, 1.0) - mean * mean, 0.0)
    rel = jnp.sqrt(var / jnp.maximum(n, 1.0)) / (jnp.abs(mean) + 0.05)
    rel = jnp.where(valid, rel, -1.0)  # pad slots never selected
    # one descending argsort (the wavefront compaction's machinery)
    idx = jnp.argsort(-rel)[:budget]
    return jnp.sort(idx)


@jax.jit
def _luma(rgb):
    return (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2])


@register_engine
class AdaptiveRenderer(FusedRenderer):
    """Fused megakernel + variance-guided pixel budgets (module doc)."""

    name = "adaptive"

    #: full-frame warmup passes that seed the variance estimate
    warmup: int = 4
    #: fraction of the frame traced per adaptive pass
    budget: float = 0.5

    def _post_init(self) -> None:
        super()._post_init()
        slots = int(self._ids.shape[0])
        r = self.config.pixel_count
        self._valid = self._ids < r
        b = int(r * self.budget)
        b = max(BLOCK, (b // BLOCK) * BLOCK)
        self._budget_slots = min(b, slots)
        self._reset_stats()

    def _reset_stats(self) -> None:
        slots = int(self._ids.shape[0])
        self._m1 = jnp.zeros(slots, jnp.float32)
        self._m2 = jnp.zeros(slots, jnp.float32)
        self._n = jnp.zeros(slots, jnp.float32)

    def reset_progressive(self) -> None:
        super().reset_progressive()
        self._reset_stats()

    def _accumulate_stats(self, sel, rad) -> None:
        lum = _luma(rad)
        if sel is None:
            v = self._valid.astype(jnp.float32)
            self._m1 = self._m1 + lum * v
            self._m2 = self._m2 + lum * lum * v
            self._n = self._n + v
        else:
            self._m1 = self._m1.at[sel].add(lum)
            self._m2 = self._m2.at[sel].add(lum * lum)
            self._n = self._n.at[sel].add(1.0)

    def progressive_render(self) -> None:
        assert self._film is not None, "init() first"
        cfg = self.config
        spp = float(cfg.samples_per_frame)
        if self._frame_index < self.warmup:
            rgb = self._trace_ids(self._ids, self._frame_index)
            if cfg.firefly_clamp > 0.0:
                rgb = jnp.minimum(rgb, cfg.firefly_clamp)
            self._accumulate_stats(None, rgb)
            self._film.add_sample_buffer(rgb, spp)
        else:
            sel = _select_slots(self._m1, self._m2, self._n, self._valid,
                                self._budget_slots)
            rgb = self._trace_ids(self._ids[sel], self._frame_index)
            if cfg.firefly_clamp > 0.0:
                rgb = jnp.minimum(rgb, cfg.firefly_clamp)
            self._accumulate_stats(sel, rgb)
            self._film.add_sample_slots(sel, rgb, spp)
        self._frame_index += 1
