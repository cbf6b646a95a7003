"""Planner flags and configuration.

The analog of `fft_flags_t` (fft_auto.h:17-29). The planning-rigor
levels (ESTIMATE/MEASURE/PATIENT/EXHAUSTIVE/WISDOM_ONLY) and behavior bits
(REAL_INPUT/REAL_OUTPUT/CONSERVE_MEMORY/PREFER_DEVICE/...) keep their
reference semantics, re-interpreted for XLA:

- ESTIMATE: pick by the size heuristic, no measurement.
- MEASURE: time candidate decompositions on the real device and cache the
  winner as wisdom — implementing what the reference left TODO
  (fft_auto.c:233-235).
- PATIENT/EXHAUSTIVE: widen the candidate set (more leaf sizes / algorithms).
- CONSERVE_MEMORY: prefer decompositions with smaller constant tables.
- PREFER_DEVICE: replaces FFT_PREFER_GPU — on this framework every
  transform is device-native, so it only influences tie-breaking toward
  matmul-heavy plans.
- THREADED: replaced by mesh sharding; kept for API parity (no-op on one
  chip; `plan_with_mesh` is the real control).
"""

from __future__ import annotations

import dataclasses
import enum


class Flags(enum.IntFlag):
    ESTIMATE = 0
    MEASURE = 1
    PATIENT = 2
    EXHAUSTIVE = 4
    WISDOM_ONLY = 8
    REAL_INPUT = 16
    REAL_OUTPUT = 32
    UNALIGNED = 64
    CONSERVE_MEMORY = 128
    PREFER_DEVICE = 256  # reference: FFT_PREFER_GPU
    THREADED = 512


# Back-compat aliases mirroring the reference names.
FFT_ESTIMATE = Flags.ESTIMATE
FFT_MEASURE = Flags.MEASURE
FFT_PATIENT = Flags.PATIENT
FFT_EXHAUSTIVE = Flags.EXHAUSTIVE
FFT_WISDOM_ONLY = Flags.WISDOM_ONLY
FFT_CONSERVE_MEMORY = Flags.CONSERVE_MEMORY
FFT_PREFER_GPU = Flags.PREFER_DEVICE


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """All planner knobs in one hashable config (SURVEY.md §5 'config/flag
    system' analog — the dataclass replaces the C bitmask + Makefile tier).

    precision: 'f32' (device default) or 'f64' (CPU oracle/parity mode).
    leaf: max radix for the Stockham path.
    """

    flags: Flags = Flags.ESTIMATE
    precision: str = "f32"
    leaf: int = 1024
    algorithm: str | None = None  # force a specific registry algorithm

    @property
    def dtype(self):
        import numpy as np

        return np.complex128 if self.precision == "f64" else np.complex64
