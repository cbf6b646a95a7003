"""Power-spectrum estimation: periodogram, Welch, correlation, coherence.

The analog of reference applications/power_spectrum.c: windowed
periodogram with power correction and one-sided 2x scaling (:58-85),
Welch's overlapping segmented average (:88-130), autocorrelation via FFT
(:133-159), cross-correlation (:162-192), spectral statistics (:227-283) —
and a REAL magnitude-squared coherence (the reference returns a 1.0
placeholder, power_spectrum.c:195-224).

Welch's segments are an embarrassingly-parallel batch dim here (one
gather forms all segments; the mean is one reduction) — the shard_map
version with `psum` averaging is dist/welch.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fftlab.core.types import Direction, complex_dtype_for, next_power_of_two
from fftlab.core.window import get_window, power_gain


def _cfft():
    from fftlab.algos.stockham import stockham_fft

    return stockham_fft


def periodogram(x, sample_rate: float = 1.0, window="hann", cfft=None):
    """One-sided PSD of real input (power_spectrum.c:58-85).

    Returns (freqs[n/2+1], psd[..., n/2+1]); window power correction uses
    the general sum(w^2)/n (the reference hardcodes Hann's 0.375).
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = get_window(window, n)
    cdtype = complex_dtype_for(x.dtype)
    xw = x * jnp.asarray(w, dtype=jnp.real(jnp.zeros((), cdtype)).dtype)
    X = cfft(xw.astype(cdtype), Direction.FORWARD)
    h = n // 2 + 1
    p = (jnp.real(X) ** 2 + jnp.imag(X) ** 2)[..., :h]
    scale = 1.0 / (sample_rate * n * power_gain(w))
    p = p * scale
    # One-sided doubling (except DC and Nyquist), power_spectrum.c:76-82.
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if n % 2 == 0:
        dbl[-1] = 1.0
    p = p * jnp.asarray(dbl, dtype=p.dtype)
    freqs = np.arange(h) * sample_rate / n
    return freqs, p


def welch_psd(x, sample_rate: float = 1.0, window_size: int = 256,
              overlap: float = 0.5, window="hann", cfft=None):
    """Welch's method: averaged overlapping windowed periodograms
    (power_spectrum.c:88-130). Segments form a batch dim via one gather.
    """
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    from fftlab.core.framing import frame_signal_strided

    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    segments = frame_signal_strided(x, window_size, hop, n_seg)
    freqs, p = periodogram(segments, sample_rate, window, cfft)
    return freqs, jnp.mean(p, axis=-2)


def autocorrelation(x, cfft=None):
    """Biased autocorrelation via FFT: pad 2n, |X|^2, IFFT
    (power_spectrum.c:133-159). Returns lags 0..n-1, normalized so r[0]=1.
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    cdtype = complex_dtype_for(x.dtype)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    X = cfft(jnp.pad(x.astype(cdtype), pad), Direction.FORWARD)
    r = cfft(X * jnp.conj(X), Direction.INVERSE)[..., :n]
    r = jnp.real(r)
    return r / jnp.maximum(r[..., :1], 1e-30)


def cross_correlation(x, y, cfft=None):
    """Cross-correlation via conj(X)*Y (power_spectrum.c:162-192).

    Returns the full two-sided sequence of length 2n-1, zero lag centered
    at index n-1 (r_xy[tau] = sum x[t]*y[t+tau]).
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    cdtype = complex_dtype_for(jnp.result_type(x, y))
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    X = cfft(jnp.pad(x.astype(cdtype), pad), Direction.FORWARD)
    Y = cfft(jnp.pad(y.astype(cdtype), pad), Direction.FORWARD)
    r = cfft(jnp.conj(X) * Y, Direction.INVERSE)
    r = jnp.real(r)
    # Negative lags live at the tail of the circular result.
    neg = r[..., m - (n - 1) :]
    pos = r[..., :n]
    return jnp.concatenate([neg, pos], axis=-1)


def coherence(x, y, sample_rate: float = 1.0, window_size: int = 256,
              overlap: float = 0.5, window="hann", cfft=None):
    """Magnitude-squared coherence C_xy = |S_xy|^2 / (S_xx * S_yy), averaged
    over Welch segments — a real implementation of the reference's
    placeholder (power_spectrum.c:195-224 returns 1.0).
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = int(x.shape[-1])
    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    if n_seg < 2:
        raise ValueError("coherence needs >= 2 Welch segments for averaging")
    from fftlab.core.framing import frame_signal_strided

    w = get_window(window, window_size)
    cdtype = complex_dtype_for(jnp.result_type(x, y))
    wk = jnp.asarray(w)

    def seg_fft(s):
        sw = frame_signal_strided(s, window_size, hop, n_seg) * wk
        return cfft(sw.astype(cdtype), Direction.FORWARD)

    X = seg_fft(x)
    Y = seg_fft(y)
    h = window_size // 2 + 1
    Sxy = jnp.mean(jnp.conj(X) * Y, axis=-2)[..., :h]
    Sxx = jnp.mean(jnp.abs(X) ** 2, axis=-2)[..., :h]
    Syy = jnp.mean(jnp.abs(Y) ** 2, axis=-2)[..., :h]
    freqs = np.arange(h) * sample_rate / window_size
    c = jnp.abs(Sxy) ** 2 / jnp.maximum(Sxx * Syy, 1e-30)
    return freqs, c


def spectral_stats(psd, freqs) -> dict:
    """Centroid, RMS bandwidth, 95% rolloff, total power
    (power_spectrum.c:227-283). Host-side on a 1D PSD."""
    p = np.asarray(psd, dtype=np.float64)
    f = np.asarray(freqs, dtype=np.float64)
    total = float(np.sum(p))
    if total <= 0:
        return {"centroid": 0.0, "bandwidth": 0.0, "rolloff_95": 0.0, "total_power": 0.0}
    centroid = float(np.sum(f * p) / total)
    bandwidth = float(np.sqrt(np.sum(((f - centroid) ** 2) * p) / total))
    cumsum = np.cumsum(p)
    rolloff = float(f[int(np.searchsorted(cumsum, 0.95 * total))])
    return {
        "centroid": centroid,
        "bandwidth": bandwidth,
        "rolloff_95": rolloff,
        "total_power": total,
    }


def autocorrelation_split(x):
    """Split-plane autocorrelation: real 1D/batched signal in, normalized
    lags 0..n-1 out, no complex dtype (pad 2n, |X|^2, inverse — the
    power_spectrum.c:133-159 pipeline on split planes).

    Matches `autocorrelation` (property-tested)."""
    from fftlab.algos.split_stockham import fft_split

    x = jnp.asarray(x, dtype=jnp.float32)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    xp = jnp.pad(x, pad)
    Xr, Xi = fft_split(xp, jnp.zeros_like(xp), Direction.FORWARD)
    pw = Xr * Xr + Xi * Xi
    rr, _ = fft_split(pw, jnp.zeros_like(pw), Direction.INVERSE)
    r = rr[..., :n]
    return r / jnp.maximum(r[..., :1], 1e-30)


def cross_correlation_split(x, y):
    """Cross-correlation on split planes: packs the two real
    signals into ONE complex transform (x -> re, y -> im), then
    Sxy[k] = conj(X)Y = (A*B* recovered via Hermitian split). Returns the
    same two-sided length 2n-1 sequence as `cross_correlation`."""
    from fftlab.algos.split_stockham import fft_split

    x = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    Zr, Zi = fft_split(jnp.pad(x, pad), jnp.pad(y, pad), Direction.FORWARD)
    # Hermitian split of Z = X + iY (both x, y real):
    #   X[k] = (Z[k] + conj(Z[-k]))/2,  Y[k] = (Z[k] - conj(Z[-k]))/(2i)
    Zr_m = jnp.roll(jnp.flip(Zr, -1), 1, -1)   # Re Z[-k]
    Zi_m = jnp.roll(jnp.flip(Zi, -1), 1, -1)   # Im Z[-k]
    Xr_, Xi_ = (Zr + Zr_m) / 2, (Zi - Zi_m) / 2
    Yr_, Yi_ = (Zi + Zi_m) / 2, (Zr_m - Zr) / 2
    # S = conj(X) * Y
    Sr = Xr_ * Yr_ + Xi_ * Yi_
    Si = Xr_ * Yi_ - Xi_ * Yr_
    rr, _ = fft_split(Sr, Si, Direction.INVERSE)
    neg = rr[..., m - (n - 1):]
    pos = rr[..., :n]
    return jnp.concatenate([neg, pos], axis=-1)


def coherence_split(x, y, sample_rate: float = 1.0, window_size: int = 256,
                    overlap: float = 0.5, window="hann"):
    """Split-plane magnitude-squared coherence: Welch cross/auto spectra
    via stft_split.

    Matches `coherence` (property-tested)."""
    from fftlab.dsp.stft import stft_split

    x = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    n = int(x.shape[-1])
    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    if n_seg < 2:
        raise ValueError("coherence needs >= 2 Welch segments for averaging")
    # x cut to exactly n_seg frames, so stft_split returns n_seg rows.
    cut = (n_seg - 1) * hop + window_size
    Xr, Xi = stft_split(x[:cut], window_size, hop, window)
    Yr, Yi = stft_split(y[:cut], window_size, hop, window)
    # S_xy = mean(conj(X) Y); S_xx, S_yy real
    Sxy_r = jnp.mean(Xr * Yr + Xi * Yi, axis=0)
    Sxy_i = jnp.mean(Xr * Yi - Xi * Yr, axis=0)
    Sxx = jnp.mean(Xr * Xr + Xi * Xi, axis=0)
    Syy = jnp.mean(Yr * Yr + Yi * Yi, axis=0)
    h = window_size // 2 + 1
    freqs = np.arange(h) * sample_rate / window_size
    return freqs, (Sxy_r**2 + Sxy_i**2) / jnp.maximum(Sxx * Syy, 1e-30)


def welch_psd_split(x, sample_rate: float = 1.0, window_size: int = 256,
                    overlap: float = 0.5, window="hann"):
    """Split-plane Welch PSD: real 1D signal in, real PSD out, no complex
    dtype anywhere (periodograms via dsp.stft.stft_split).

    Matches `welch_psd` (property-tested)."""
    from fftlab.dsp.stft import stft_split

    x = jnp.asarray(x, dtype=jnp.float32)
    n = int(x.shape[-1])
    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    Xr, Xi = stft_split(x[: (n_seg - 1) * hop + window_size],
                        window_size, hop, window)
    w = get_window(window, window_size)
    h = window_size // 2 + 1
    p = (Xr * Xr + Xi * Xi)[:n_seg, :h]
    scale = 1.0 / (sample_rate * window_size * power_gain(w))
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if window_size % 2 == 0:
        dbl[-1] = 1.0
    psd = jnp.mean(p, axis=0) * scale * jnp.asarray(dbl, dtype=p.dtype)
    freqs = np.arange(h) * sample_rate / window_size
    return freqs, psd
