"""Tracing / profiling utilities (SURVEY §5).

The reference's PerfChrono wall-clock timers and time-per-ray display
(reference: chrono.h:6-64, Raytracer.cpp:1446+1533+1696, mainApp.cpp:
1168-1170) become: a block timer that waits for the device
(jax.block_until_ready), a rays/s accounting helper, and a jax.profiler
trace context for device traces.
"""

from __future__ import annotations

import contextlib
import time

import jax


class PerfChrono:
    """Device-synchronized wall timer (the reference's PerfChrono)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def diff_ms(self, sync=None):
        if sync is not None:
            jax.block_until_ready(sync)
        return (time.perf_counter() - self._t0) * 1000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context — view with TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def rays_per_second(width, height, spp, nb_bounces, seconds,
                    shadow_rays_per_bounce=1):
    """Hardware ray-op accounting for the lockstep wavefront: every lane
    does one closest-hit and `shadow_rays_per_bounce` any-hit sweeps per
    bounce (no compaction), so ray ops = W*H*spp*bounces*(1+shadow)."""
    total = width * height * spp * nb_bounces * (1 + shadow_rays_per_bounce)
    return total / max(seconds, 1e-12)
