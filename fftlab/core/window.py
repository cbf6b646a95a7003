"""Window functions for spectral analysis.

The analog of the reference's window set: Hann/Hamming/Blackman
(audio_spectrum.c:37-57, power_spectrum.c:5-25), Tukey (fft_utils.c:60-74),
and a REAL Kaiser window (the reference's Kaiser is a stub returning 1.0,
fft_utils.c:49-58 — implemented correctly here via the I0 Bessel series).

Windows are plan-time constants: computed host-side in float64 numpy,
converted to the requested dtype at the call site. `periodic=True` (the
DFT-analysis convention) divides by n rather than n-1, matching the
reference's spectral-analysis usage.
"""

from __future__ import annotations

import functools

import numpy as np


def _grid(n: int, periodic: bool) -> np.ndarray:
    denom = n if periodic else max(n - 1, 1)
    return np.arange(n, dtype=np.float64) / denom


@functools.lru_cache(maxsize=None)
def rectangular(n: int, periodic: bool = True) -> np.ndarray:
    return np.ones(n, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def hann(n: int, periodic: bool = True) -> np.ndarray:
    """0.5*(1-cos(2*pi*t)) (audio_spectrum.c:39-43)."""
    return 0.5 * (1.0 - np.cos(2 * np.pi * _grid(n, periodic)))


@functools.lru_cache(maxsize=None)
def hamming(n: int, periodic: bool = True) -> np.ndarray:
    """0.54 - 0.46*cos(2*pi*t) (audio_spectrum.c:45-49)."""
    return 0.54 - 0.46 * np.cos(2 * np.pi * _grid(n, periodic))


@functools.lru_cache(maxsize=None)
def blackman(n: int, periodic: bool = True) -> np.ndarray:
    """0.42 - 0.5*cos(2*pi*t) + 0.08*cos(4*pi*t) (audio_spectrum.c:51-56)."""
    t = _grid(n, periodic)
    return 0.42 - 0.5 * np.cos(2 * np.pi * t) + 0.08 * np.cos(4 * np.pi * t)


def _i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0 (series)."""
    return np.i0(x)


@functools.lru_cache(maxsize=None)
def kaiser(n: int, beta: float = 8.6, periodic: bool = True) -> np.ndarray:
    """Real Kaiser window I0(beta*sqrt(1-(2t-1)^2))/I0(beta).

    The reference declares this but ships a window=1.0 stub
    (fft_utils.c:49-58); implemented for real here.
    """
    t = 2.0 * _grid(n, periodic) - 1.0
    return _i0(beta * np.sqrt(np.clip(1.0 - t * t, 0.0, 1.0))) / _i0(beta)


@functools.lru_cache(maxsize=None)
def tukey(n: int, alpha: float = 0.5, periodic: bool = True) -> np.ndarray:
    """Tapered-cosine window (fft_utils.c:60-74)."""
    if alpha <= 0:
        return rectangular(n, periodic)
    if alpha >= 1:
        return hann(n, periodic)
    t = _grid(n, periodic)
    w = np.ones(n, dtype=np.float64)
    lo = t < alpha / 2
    hi = t >= 1 - alpha / 2
    w[lo] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[lo] - alpha / 2)))
    w[hi] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[hi] - 1 + alpha / 2)))
    return w


WINDOWS = {
    "rectangular": rectangular,
    "boxcar": rectangular,
    "hann": hann,
    "hanning": hann,
    "hamming": hamming,
    "blackman": blackman,
    "kaiser": kaiser,
    "tukey": tukey,
}


def get_window(name_or_array, n: int, periodic: bool = True, **kwargs) -> np.ndarray:
    """Resolve a window by name (or pass an array through, length-checked)."""
    if isinstance(name_or_array, str):
        try:
            fn = WINDOWS[name_or_array.lower()]
        except KeyError:
            raise ValueError(
                f"unknown window {name_or_array!r}; known: {sorted(set(WINDOWS))}"
            ) from None
        # Copy: the window fns are lru_cached, so handing out the cached
        # array would let one caller's in-place edit corrupt every
        # future get_window result process-wide.
        return fn(n, periodic=periodic, **kwargs).copy()
    w = np.asarray(name_or_array, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"window has shape {w.shape}, expected ({n},)")
    return w


def coherent_gain(w: np.ndarray) -> float:
    """sum(w)/n — amplitude correction factor."""
    return float(np.sum(w) / len(w))


def power_gain(w: np.ndarray) -> float:
    """sum(w^2)/n — power (PSD) correction factor.

    (The reference hard-codes Hann's 0.375 at power_spectrum.c:58-85;
    computed generally here.)
    """
    return float(np.sum(w * w) / len(w))
