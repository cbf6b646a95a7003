"""Pitch detection: spectral peak, harmonic product spectrum, and
FFT-autocorrelation, combined with a confidence vote.

The analog of reference examples/pitch_detection.c: the 97-note
C0-C8 frequency table (:23-51), cents-offset tuner (:54-75), spectral-peak
detector with parabolic interpolation (:78-109), harmonic product spectrum
(:112-147), autocorrelation pitch (:150-189), and the variance-based
combination (:199-233).

Detectors are batched: input [..., n] real frames -> per-frame pitch.
The FFT work is one batched transform; the argmax/interpolation epilogues
are tiny reductions.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from fftlab.algos.real_fft import rfft
from fftlab.core.window import get_window
from fftlab.dsp.spectrum import autocorrelation

A4 = 440.0
NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


@functools.lru_cache(maxsize=1)
def note_table() -> list[tuple[str, float]]:
    """97 notes C0..C8 with equal-temperament frequencies
    (pitch_detection.c:23-51). C0 = A4 * 2^(-57/12)."""
    notes = []
    for i in range(97):
        # i semitones above C0; A4 is 57 semitones above C0.
        freq = A4 * 2.0 ** ((i - 57) / 12.0)
        name = NOTE_NAMES[i % 12] + str(i // 12)
        notes.append((name, freq))
    return notes


def freq_to_note(freq: float) -> tuple[str, float]:
    """Nearest note name + cents offset (pitch_detection.c:54-75;
    audio_spectrum.c:181-198 log2-cents math)."""
    if freq <= 0:
        return ("?", 0.0)
    semis = 12.0 * np.log2(freq / A4) + 57.0  # semitones above C0
    idx = int(np.clip(round(semis), 0, 96))
    name, f_note = note_table()[idx]
    cents = 1200.0 * np.log2(freq / f_note)
    return (name, float(cents))


def _parabolic_refine(mag, k):
    """Quadratic-interpolated peak offset in [-0.5, 0.5] around bin k
    (fft_utils.c:145-168; pitch_detection.c:96-104)."""
    km = jnp.clip(k - 1, 0, mag.shape[-1] - 1)
    kp = jnp.clip(k + 1, 0, mag.shape[-1] - 1)
    a = jnp.take_along_axis(mag, km[..., None], axis=-1)[..., 0]
    b = jnp.take_along_axis(mag, k[..., None], axis=-1)[..., 0]
    c = jnp.take_along_axis(mag, kp[..., None], axis=-1)[..., 0]
    denom = a - 2 * b + c
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (a - c) / denom, 0.0)
    return jnp.clip(delta, -0.5, 0.5)


def pitch_spectral_peak(x, sample_rate: float, window="hann",
                        fmin: float = 20.0, fmax: float | None = None,
                        cfft=None):
    """Spectral-peak pitch with parabolic interpolation
    (pitch_detection.c:78-109). x: [..., n] real -> [...] Hz."""
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = jnp.asarray(get_window(window, n), dtype=x.dtype)
    X = rfft(x * w, cfft)
    mag = jnp.abs(X)
    h = mag.shape[-1]
    if fmax is None:
        fmax = sample_rate / 2.0
    kmin = max(int(np.ceil(fmin * n / sample_rate)), 1)
    kmax = min(int(fmax * n / sample_rate), h - 1)
    mask = np.zeros(h)
    mask[kmin : kmax + 1] = 1.0
    mag = mag * jnp.asarray(mask, dtype=mag.dtype)
    k = jnp.argmax(mag, axis=-1)
    delta = _parabolic_refine(mag, k)
    return (k + delta) * (sample_rate / n)


def harmonic_product_spectrum(x, sample_rate: float, n_harmonics: int = 4,
                              window="hann", fmin: float = 20.0, cfft=None):
    """HPS pitch: product of the spectrum with its 2x..Hx downsampled
    copies; the fundamental survives, harmonics cancel
    (pitch_detection.c:112-147)."""
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = jnp.asarray(get_window(window, n), dtype=x.dtype)
    mag = jnp.abs(rfft(x * w, cfft))
    h = int(mag.shape[-1])
    m = h // n_harmonics
    hps = mag[..., :m]
    for r in range(2, n_harmonics + 1):
        hps = hps * mag[..., : r * m : r][..., :m]
    kmin = max(int(np.ceil(fmin * n / sample_rate)), 1)
    mask = np.zeros(m)
    mask[kmin:] = 1.0
    hps = hps * jnp.asarray(mask, dtype=hps.dtype)
    k = jnp.argmax(hps, axis=-1)
    delta = _parabolic_refine(hps, k)
    return (k + delta) * (sample_rate / n)


def pitch_autocorrelation(x, sample_rate: float, fmin: float = 50.0,
                          fmax: float = 2000.0, cfft=None):
    """Autocorrelation pitch via FFT (pitch_detection.c:150-189): the lag
    of the autocorrelation peak inside [1/fmax, 1/fmin] is the period."""
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    r = autocorrelation(x, cfft)  # [..., n], r[0]=1
    lag_min = max(int(sample_rate / fmax), 1)
    lag_max = min(int(sample_rate / fmin), n - 1)
    mask = np.zeros(n)
    mask[lag_min : lag_max + 1] = 1.0
    rm = r * jnp.asarray(mask, dtype=r.dtype) - (1 - jnp.asarray(mask, dtype=r.dtype))
    k = jnp.argmax(rm, axis=-1)
    delta = _parabolic_refine(rm, k)
    lag = k + delta
    return jnp.where(lag > 0, sample_rate / jnp.maximum(lag, 1e-9), 0.0)


def detect_pitch(x, sample_rate: float, cfft=None) -> dict:
    """Run all three detectors and combine by agreement-weighted vote
    (pitch_detection.c:199-233 variance-based confidence). Host-side
    epilogue on a single frame."""
    f1 = float(np.asarray(pitch_spectral_peak(x, sample_rate, cfft=cfft)))
    f2 = float(np.asarray(harmonic_product_spectrum(x, sample_rate, cfft=cfft)))
    f3 = float(np.asarray(pitch_autocorrelation(x, sample_rate, cfft=cfft)))
    ests = np.array([f1, f2, f3])
    valid = ests[ests > 0]
    if len(valid) == 0:
        return {"pitch": 0.0, "confidence": 0.0, "estimates": ests.tolist(),
                "note": "?", "cents": 0.0}
    med = float(np.median(valid))
    # Agreement: estimates within 3% of the median vote for it.
    agree = valid[np.abs(valid - med) < 0.03 * med]
    pitch = float(np.mean(agree)) if len(agree) else med
    confidence = len(agree) / 3.0
    name, cents = freq_to_note(pitch)
    return {"pitch": pitch, "confidence": confidence,
            "estimates": ests.tolist(), "note": name, "cents": cents}
