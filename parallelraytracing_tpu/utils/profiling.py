"""Profiling / tracing hooks.

The counterpart of the reference's observability layer: host-side
chrono brackets + ImGui graphs (main.cpp:265-462,512-532) and external
Nsight profiling (wavefront.md:106-114).  Here:

- `trace(...)`: context manager capturing a jax.profiler trace viewable in
  Perfetto/XProf/TensorBoard — the Nsight Systems analogue.
- `annotate(name)`: a TraceAnnotation so frame stages show up as named
  spans inside the device trace.
- `rays_per_second(...)`: the headline counter the reference never
  recorded (its stated goal was samples/sec, wavefront.md:28-36).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/prt_trace") -> Iterator[str]:
    """Capture a device+host profiler trace into log_dir."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span annotation appearing in profiler traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def rays_per_second(rays_per_frame: float, seconds_per_frame: float) -> float:
    return rays_per_frame / max(seconds_per_frame, 1e-12)


class ThroughputMeter:
    """Rolling rays/sec + frames/sec counter for the viewer/CLI HUD."""

    def __init__(self, window: int = 100):
        self._times: list = []
        self._rays: list = []
        self.window = window

    def tick(self, rays: float) -> None:
        self._times.append(time.perf_counter())
        self._rays.append(rays)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._rays.pop(0)

    @property
    def mrays_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._rays[1:]) / max(dt, 1e-12) / 1e6

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / max(
            self._times[-1] - self._times[0], 1e-12)
