"""Twiddle-factor and DFT-matrix tables.

The analog of the reference's `twiddle_factor()` (fft_common.h:89-98)
and of the planner's precomputed twiddle tables (fft_auto.c:199-212 — which
the reference computes but never uses; here they ARE the execution path).

All tables are computed host-side in float64 numpy (compensated twiddle
generation — the float32 kernels then see correctly-rounded constants) and
cached per (n, direction). They become XLA constants at trace time, so on
a device they live in device memory as plan-time data, exactly the
"plan = cached decomposition + baked tables" design from SURVEY.md §7.
"""

from __future__ import annotations

import functools

import numpy as np

from fftlab.core.types import Direction


@functools.lru_cache(maxsize=None)
def twiddle_np(n: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """w[k] = exp(2*pi*i*direction*k/n), k = 0..n-1, complex128.

    Matches the reference basis (fft_common.h:89-98) where FORWARD = -1
    gives the conventional exp(-2*pi*i*k/n).
    """
    k = np.arange(n, dtype=np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * k / n)


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Full n x n DFT matrix F[j,k] = exp(2*pi*i*direction*j*k/n), complex128.

    The matmul "codelet": a leaf transform of size n is a single matmul
    against this matrix. (The reference's optimized_dft.c:29-77 builds the
    same full twiddle cache; here it feeds one contraction.)

    Computed via outer-product of exact integer products mod n to avoid
    accumulating phase error for large n.
    """
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n).astype(np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * jk / n)


@functools.lru_cache(maxsize=None)
def stage_twiddle_np(r: int, m: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Cooley-Tukey inter-stage twiddles for n = r*m, shape (r, m).

    T[a, b] = exp(2*pi*i*direction*a*b/(r*m)). Applied after the radix-r
    leaf DFT over the 'a' digit and before the size-m sub-transform over
    the 'b' digits (four-step step 2, parallel_fft.c:248-255 semantics).
    """
    n = r * m
    a = np.arange(r, dtype=np.int64)
    b = np.arange(m, dtype=np.int64)
    ab = np.mod(np.outer(a, b), n).astype(np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * ab / n)


@functools.lru_cache(maxsize=None)
def butterfly_twiddle_np(m: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Radix-2 butterfly twiddles for a stage of span m: w[j] = W_m^j, j<m/2.

    (The running-twiddle recurrence of radix2_dit.c:84-112, materialized.)
    """
    j = np.arange(m // 2, dtype=np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * j / m)


@functools.lru_cache(maxsize=None)
def chirp_np(n: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Bluestein chirp c[k] = exp(pi*i*direction*k^2/n) (bluestein.c:51-65).

    k^2 is reduced mod 2n exactly in integer arithmetic before the complex
    exponential, keeping the phase accurate for very large n.
    """
    k = np.arange(n, dtype=np.int64)
    k2 = np.mod(k * k, 2 * n).astype(np.float64)
    return np.exp(1j * np.pi * float(int(direction)) * k2 / n)
