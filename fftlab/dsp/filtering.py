"""Frequency-domain FFT filtering.

The analog of reference applications/fft_filtering.c: ideal
brick-wall responses with negative-frequency handling (:37-71),
raised-cosine transition bands (:74-108), the FFT -> H[k] -> IFFT filter
(:111-132), and FIR design by frequency sampling (:135-161).

The filter response H is a plan-time float64 constant; the hot path is the
FFT -> pointwise -> IFFT sandwich (SURVEY.md §3.4 calls this THE pipeline
to fuse — see split_stockham.spectral_filter_split_fused for the
zero-transpose version and dist/overlap_save.py for the sharded
streaming version).
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np

from fftlab.core.types import Direction, complex_dtype_for
from fftlab.core.window import hamming


class FilterType(enum.Enum):
    """fft_filtering.c:19-25."""

    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    BANDSTOP = "bandstop"
    CUSTOM = "custom"


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """fft_filtering.c:28-34."""

    filter_type: FilterType
    cutoff_low: float  # Hz (or cycles/window if sample_rate == n)
    cutoff_high: float = 0.0  # upper edge for band filters
    sample_rate: float = 1.0
    transition_width: float = 0.0  # Hz; 0 = ideal brick wall


def ideal_response(n: int, params: FilterParams) -> np.ndarray:
    """Brick-wall |H[k]| over the full FFT grid, with correct
    negative-frequency mirroring for k > n/2 (fft_filtering.c:37-71)."""
    k = np.arange(n)
    freq = k * params.sample_rate / n
    freq = np.where(k > n // 2, params.sample_rate - freq, freq)  # fold negatives
    ft = params.filter_type
    if ft == FilterType.LOWPASS:
        h = (freq <= params.cutoff_low).astype(np.float64)
    elif ft == FilterType.HIGHPASS:
        h = (freq >= params.cutoff_low).astype(np.float64)
    elif ft == FilterType.BANDPASS:
        h = ((freq >= params.cutoff_low) & (freq <= params.cutoff_high)).astype(np.float64)
    elif ft == FilterType.BANDSTOP:
        h = ((freq < params.cutoff_low) | (freq > params.cutoff_high)).astype(np.float64)
    else:
        raise ValueError("CUSTOM responses: pass H directly to fft_filter_custom")
    return h


def apply_transition_band(h: np.ndarray, n: int, params: FilterParams) -> np.ndarray:
    """Smooth each 0/1 edge with a raised-cosine of `transition_width` Hz
    (fft_filtering.c:74-108)."""
    if params.transition_width <= 0:
        return h
    half_bins = max(int(round(params.transition_width / 2 * n / params.sample_rate)), 1)
    out = h.copy()
    half = n // 2
    edges = [k for k in range(1, half + 1) if h[k] != h[k - 1]]
    for e in edges:
        rising = h[e] > h[e - 1]
        for i in range(-half_bins, half_bins + 1):
            k = e + i
            if 0 <= k <= half:
                x = (i + half_bins) / (2 * half_bins)  # 0..1 across the band
                c = 0.5 * (1 - np.cos(np.pi * x))  # raised cosine 0 -> 1
                out[k] = c if rising else 1.0 - c
    # Mirror onto negative frequencies so the impulse response stays real.
    for k in range(half + 1, n):
        out[k] = out[n - k]
    return out


def design_response(n: int, params: FilterParams) -> np.ndarray:
    """Full-grid real |H[k]| including transition bands."""
    return apply_transition_band(ideal_response(n, params), n, params)


def fft_filter(x, params: FilterParams, cfft=None):
    """Filter a block: IFFT(H .* FFT(x)) (fft_filtering.c:111-132).

    x: real or complex [..., n]; returns same domain as input.
    """
    h = design_response(int(jnp.shape(x)[-1]), params)
    return fft_filter_custom(x, h, cfft)


def fft_filter_custom(x, h, cfft=None):
    """Filter with an arbitrary frequency response H[k] (CUSTOM type)."""
    if cfft is None:
        from fftlab.algos.stockham import stockham_fft as cfft
    x = jnp.asarray(x)
    was_real = np.dtype(x.dtype).kind != "c"
    cdtype = complex_dtype_for(x.dtype)
    X = cfft(x.astype(cdtype), Direction.FORWARD)
    H = jnp.asarray(np.asarray(h), dtype=cdtype)
    y = cfft(X * H, Direction.INVERSE)
    return jnp.real(y) if was_real else y


def design_fir(num_taps: int, params: FilterParams, cfft=None) -> np.ndarray:
    """FIR design by frequency sampling: sample H on an n-point grid,
    IFFT, center (circular shift), Hamming-window (fft_filtering.c:135-161).

    Host-side float64; returns the real tap vector.
    """
    n = num_taps
    h_mag = design_response(n, params)
    from fftlab.core.hostfft import host_fft_pow2
    from fftlab.core.types import next_power_of_two

    if n == next_power_of_two(n):
        imp = host_fft_pow2(h_mag.astype(np.complex128), Direction.INVERSE)
    else:
        # Small-n direct inverse DFT (design-time only).
        k = np.arange(n)
        Finv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
        imp = Finv @ h_mag.astype(np.complex128)
    imp = np.real(imp)
    imp = np.roll(imp, n // 2)  # linear-phase centering
    return imp * hamming(n, periodic=False)


def fft_filter_split(xr, xi, params: FilterParams):
    """Device fast-path block filter on split re/im planes: the fused
    zero-transpose FFT -> H -> IFFT sandwich (split_stockham.
    spectral_filter_split_fused) with a plan-time real response H.

    Returns (yr, yi). For a pair of REAL channels pack them as
    (xr=ch0, xi=ch1): a real H is Hermitian-symmetric, so filtering
    commutes with Re/Im extraction and yr/yi are the two filtered
    channels — two real filters for the price of one complex one.
    """
    import jax.numpy as jnp

    from fftlab.plan.dispatch import spectral_filter_auto

    xr = jnp.asarray(xr)
    n = int(xr.shape[-1])
    h = design_response(n, params)
    rdtype = xr.dtype

    # Route policy lives in plan.dispatch.
    return spectral_filter_auto(xr, xi, h.astype(rdtype),
                                np.zeros(n, rdtype))
