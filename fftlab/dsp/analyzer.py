"""Audio spectrum analysis: windowed spectra, peak finding, note mapping,
and the streaming (realtime) analyzer.

The analog of reference applications/audio_spectrum.c (windows
:37-57, bin<->freq :76-78, local-max peak finder sorted by magnitude
:87-115, freq->note :181-198) and examples/realtime_analyzer.c (circular
buffer + hop trigger :58-93, EMA-averaged magnitude :75-91, peak tracking
with parabolic interpolation + phase :188-221; config fft_size=2048,
hop=512, Hann, 4-frame averaging :229-235).

The streaming hop loop becomes a batched STFT (dsp/stft.py): all hops are
one gather + one batched transform; the EMA is a `lax.scan`. Peak
extraction is a host-side epilogue on the (small) magnitude output.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from fftlab.algos.real_fft import rfft, rfftfreq
from fftlab.core.window import get_window
from fftlab.dsp.pitch import freq_to_note
from fftlab.dsp.stft import spectrogram


def bin_to_freq(k, n: int, sample_rate: float) -> float:
    """audio_spectrum.c:76."""
    return k * sample_rate / n


def freq_to_bin(f, n: int, sample_rate: float) -> int:
    """audio_spectrum.c:78."""
    return int(round(f * n / sample_rate))


def analyze_spectrum(x, sample_rate: float, window="hann", cfft=None):
    """One-shot windowed magnitude spectrum of a real frame.

    Returns (freqs[n/2+1], magnitude[..., n/2+1]) with coherent-gain
    amplitude correction (so a unit sine reads ~1.0)."""
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = get_window(window, n)
    X = rfft(x * jnp.asarray(w, dtype=x.dtype), cfft)
    # amplitude correction: 2/(n*coherent_gain) for one-sided bins —
    # except DC and Nyquist, which have no mirrored twin (same exemption
    # as spectrum.periodogram); a DC level of 0.5 reads 0.5, not 1.0.
    cg = float(np.sum(w) / n)
    h = n // 2 + 1
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if n % 2 == 0:
        dbl[-1] = 1.0
    mag = jnp.abs(X) * jnp.asarray(dbl / (n * cg), dtype=jnp.abs(X).dtype)
    freqs = rfftfreq(n, 1.0 / sample_rate)
    return freqs, mag


@dataclasses.dataclass
class Peak:
    """A spectral peak (audio_spectrum.c peak struct; realtime_analyzer.c
    peak tracking with interpolation + phase :188-221)."""

    freq: float
    magnitude: float
    bin: float
    phase: float = 0.0
    note: str = ""
    cents: float = 0.0


def find_peaks(mag, freqs, num_peaks: int = 5, threshold: float = 0.0,
               phase=None) -> list[Peak]:
    """Local maxima above threshold, parabolic-interpolated, sorted by
    magnitude descending (audio_spectrum.c:87-115 — but argsort, not
    bubble sort). Host-side on a 1D magnitude array."""
    m = np.asarray(mag, dtype=np.float64)
    f = np.asarray(freqs, dtype=np.float64)
    n = len(m)
    if n < 3:
        return []
    interior = m[1:-1]
    is_peak = (interior > m[:-2]) & (interior >= m[2:]) & (interior > threshold)
    idx = np.nonzero(is_peak)[0] + 1
    if len(idx) == 0:
        return []
    order = np.argsort(m[idx])[::-1][:num_peaks]
    peaks = []
    df = f[1] - f[0] if n > 1 else 1.0
    for k in idx[order]:
        a, b, c = m[k - 1], m[k], m[k + 1]
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        delta = float(np.clip(delta, -0.5, 0.5))
        freq = f[k] + delta * df
        magv = b - 0.25 * (a - c) * delta
        ph = float(np.asarray(phase)[k]) if phase is not None else 0.0
        name, cents = freq_to_note(freq)
        peaks.append(Peak(freq=float(freq), magnitude=float(magv),
                          bin=float(k + delta), phase=ph, note=name,
                          cents=cents))
    return peaks


def analyze_peaks(x, sample_rate: float, num_peaks: int = 5,
                  window="hann", threshold_ratio: float = 0.01,
                  cfft=None) -> list[Peak]:
    """Windowed FFT + peak extraction with note names (the
    audio_spectrum.c main pipeline)."""
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = get_window(window, n)
    X = rfft(x * jnp.asarray(w, dtype=x.dtype), cfft)
    mag = np.asarray(jnp.abs(X))
    ph = np.asarray(jnp.angle(X))
    freqs = rfftfreq(n, 1.0 / sample_rate)
    thr = threshold_ratio * float(mag.max()) if mag.size else 0.0
    return find_peaks(mag, freqs, num_peaks, thr, phase=ph)


@dataclasses.dataclass(frozen=True)
class AnalyzerConfig:
    """realtime_analyzer.c:229-235 defaults."""

    fft_size: int = 2048
    hop: int = 512
    sample_rate: float = 44100.0
    window: str = "hann"
    averaging: int = 4
    num_peaks: int = 5


class RealtimeAnalyzer:
    """Streaming spectrum analyzer (realtime_analyzer.c re-design).

    The reference processes one hop at a time from a circular buffer; on
    an accelerator the natural unit is a CHUNK of samples — `process(chunk)` frames
    every hop inside it (plus the carried overlap tail), runs one batched
    windowed FFT, EMA-averages the frames, and returns the latest
    averaged magnitude spectrum. State = (overlap tail, EMA carry).
    """

    def __init__(self, config: AnalyzerConfig = AnalyzerConfig(), cfft=None):
        self.config = config
        self.cfft = cfft
        self._tail = np.zeros(0, dtype=np.float32)
        self._avg: np.ndarray | None = None

    def process(self, chunk) -> np.ndarray | None:
        """Feed samples; returns the averaged magnitude spectrum after the
        newest complete frame, or None until a full frame accumulates."""
        c = self.config
        buf = np.concatenate([self._tail, np.asarray(chunk, dtype=np.float32)])
        if len(buf) < c.fft_size:
            self._tail = buf
            return self._avg
        n_frames = (len(buf) - c.fft_size) // c.hop + 1
        consumed = n_frames * c.hop
        self._tail = buf[consumed:]
        # Frame ON DEVICE via stft_split: the host ships the raw chunk once instead of a host-built
        # frame tensor that is overlap-factor x larger. The cut length
        # yields exactly n_frames ceil-framed windows, so no zero-padded
        # phantom frame enters the EMA. No complex dtype anywhere.
        from fftlab.dsp.stft import stft_split

        cut = (n_frames - 1) * c.hop + c.fft_size
        Xr, Xi = stft_split(jnp.asarray(buf[:cut]), c.fft_size, c.hop,
                            c.window)
        mags = np.asarray(jnp.sqrt(Xr * Xr + Xi * Xi))
        alpha = 1.0 / c.averaging
        avg = self._avg if self._avg is not None else mags[0]
        for m in mags:  # EMA across frames (realtime_analyzer.c:86-91)
            avg = (1 - alpha) * avg + alpha * m
        self._avg = avg
        return avg

    def peaks(self) -> list[Peak]:
        """Tracked peaks of the current averaged spectrum
        (realtime_analyzer.c:188-221)."""
        if self._avg is None:
            return []
        c = self.config
        freqs = rfftfreq(c.fft_size, 1.0 / c.sample_rate)
        thr = 0.01 * float(self._avg.max())
        return find_peaks(self._avg, freqs, c.num_peaks, thr)

    def spectrogram_batch(self, signal):
        """Whole-signal offline path: the batched STFT spectrogram with
        the same EMA (dsp/stft.py).

        Like process(), the default path is complex-free (stft_split);
        a custom `cfft` opts into the complex stft path."""
        c = self.config
        x = jnp.asarray(signal, dtype=jnp.float32)
        if self.cfft is not None or x.ndim != 1:
            return spectrogram(x, c.fft_size, c.hop, c.window,
                               c.averaging, self.cfft)
        from fftlab.dsp.stft import stft_split

        Xr, Xi = stft_split(x, c.fft_size, c.hop, c.window)
        mag = jnp.sqrt(Xr * Xr + Xi * Xi)
        if c.averaging > 1:
            import jax

            alpha = 1.0 / c.averaging

            def ema(carry, m):
                carry = (1 - alpha) * carry + alpha * m
                return carry, carry

            _, mag = jax.lax.scan(ema, mag[0], mag)
        return mag
