"""Tracing / profiling utilities.

The analog of the reference's `fft_timer_t` (fft_common.h:101-114)
plus what it lacks (SURVEY.md §5): device-accurate timing with warm-up +
sync semantics, span timers, and `jax.profiler` trace capture for
flamegraph-level inspection (docs/performance.md:240-259 recommends
external perf/Instruments; here it is built in).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """start/stop/elapsed_ms timer (fft_timer_t semantics) that also
    accumulates across start/stop cycles."""

    _t0: float = 0.0
    total_s: float = 0.0
    laps: list = field(default_factory=list)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.laps.append(dt)
        return dt

    @property
    def elapsed_ms(self) -> float:
        return self.total_s * 1e3


@contextlib.contextmanager
def span(name: str, timers: dict | None = None, sync: bool = True):
    """Named timing span; device-synced on exit so the measured time is
    real device time, not dispatch time.

    The sync enqueues a trivial computation AFTER the span's work and
    reads its bytes back: per-device streams execute in order, so the
    readback fences everything the span dispatched (`effects_barrier`
    only waits for EFFECTFUL computations — pure jitted work would slip
    through and the span would record ~0 dispatch time; on this
    project's backend even block_until_ready under-waits, only a
    readback is reliable — see fftlab/bench/timing.py).
    For statistically sound benchmarks use bench.timing.chain_time; a
    span measures one-shot wall time including dispatch."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            import jax
            import jax.numpy as jnp
            import numpy as np

            try:
                # In-order device stream: reading back a fresh op's
                # bytes implies all prior work on the device finished.
                np.asarray(jnp.zeros(()) + time.perf_counter())
            except Exception:
                try:
                    jax.effects_barrier()
                except Exception:
                    pass
        dt = time.perf_counter() - t0
        if timers is not None:
            timers.setdefault(name, Timer()).laps.append(dt)
            timers[name].total_s += dt


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """TraceAnnotation context for marking regions inside a trace."""
    import jax

    return jax.profiler.TraceAnnotation(name)
