"""Spectrum metrics and error measures.

The analog of fft_common.h:167-196 (magnitude/phase/power),
fft_utils.c:145-187 (interpolated peak finding, SNR) and the benchmark
error measures (benchmark_all.c:79-91).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def magnitude(X):
    """|X| (fft_common.h:167-173)."""
    return jnp.abs(X)


def phase(X):
    """arg(X) (fft_common.h:175-181)."""
    return jnp.angle(X)


def power_spectrum_bins(X):
    """|X|^2 (fft_common.h:183-196)."""
    return jnp.real(X) ** 2 + jnp.imag(X) ** 2


def max_error(a, b) -> float:
    """Max absolute complex error (benchmark_all.c:79-85)."""
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def rms_error(a, b) -> float:
    """RMS complex error (benchmark_all.c:86-91)."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(np.sqrt(np.mean(d * d)))


def snr_db(signal, reference) -> float:
    """SNR of `signal` against ground-truth `reference`, in dB
    (fft_utils.c:170-187)."""
    reference = np.asarray(reference)
    noise = np.asarray(signal) - reference
    p_sig = np.sum(np.abs(reference) ** 2)
    p_noise = np.sum(np.abs(noise) ** 2)
    if p_noise == 0:
        return float("inf")
    return float(10.0 * np.log10(p_sig / p_noise))


def find_peak_interpolated(mag, lo: int = 1, hi: int | None = None):
    """Peak bin with parabolic (quadratic) interpolation
    (fft_utils.c:145-168): returns (refined_bin, refined_magnitude).

    Host-side numpy on a 1D magnitude array.
    """
    mag = np.asarray(mag, dtype=np.float64)
    n = len(mag)
    hi = hi if hi is not None else n // 2
    hi = min(hi, n - 1)
    if hi <= lo:
        return float(np.argmax(mag[: hi + 1])), float(np.max(mag[: hi + 1]))
    k = int(lo + np.argmax(mag[lo : hi + 1]))
    if k == 0 or k == n - 1:
        return float(k), float(mag[k])
    a, b, c = mag[k - 1], mag[k], mag[k + 1]
    denom = a - 2 * b + c
    delta = 0.0 if denom == 0 else 0.5 * (a - c) / denom
    peak = b - 0.25 * (a - c) * delta
    return float(k + delta), float(peak)


def spectral_centroid(mag, sample_rate: float, n: int) -> float:
    """Weighted mean frequency (power_spectrum.c:227-243)."""
    mag = np.asarray(mag[: n // 2], dtype=np.float64)
    freqs = np.arange(len(mag)) * sample_rate / n
    p = mag * mag
    total = np.sum(p)
    return float(np.sum(freqs * p) / total) if total > 0 else 0.0
