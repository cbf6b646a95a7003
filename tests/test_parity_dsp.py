"""Float64-oracle parity of the spectral-DSP entry points at the sizes
users run: the FFT -> H -> IFFT sandwich, FilterPlan (whole signal,
packed real, stream), STFT, Welch and the 2D transform.

Everything computes in float32 with its contractions at
Precision.HIGHEST (near 130 dB against float64); each check must reach
SNR_DB = 100 dB, which a contraction that slipped to TF32 (near 60 dB)
cannot.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fftlab.core.types import FORWARD, INVERSE

SNR_DB = 100.0


def snr_db(got, want) -> float:
    got = np.asarray(got, np.complex128)
    err = np.sum(np.abs(got - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return (z, jnp.asarray(np.ascontiguousarray(z.real)),
            jnp.asarray(np.ascontiguousarray(z.imag)))


def _join(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _id(shape):
    return "x".join(str(d) for d in shape)


@pytest.mark.parametrize("shape", [
    (1 << 10,), (1 << 12,), (1 << 14,), (1 << 16,), (1 << 18,), (1 << 20,),
    (3 << 8,), (3 << 12,), (4, 1 << 12), (2, 2, 1 << 10),
], ids=_id)
def test_spectral_filter_auto_matches_sandwich(shape):
    from fftlab.plan.dispatch import spectral_filter_auto

    n = shape[-1]
    z, xr, xi = _planes(shape, seed=n % 97)
    rng = np.random.default_rng(n % 89)
    H = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    got = _join(*spectral_filter_auto(xr, xi, np.ascontiguousarray(H.real),
                                      np.ascontiguousarray(H.imag)))
    want = np.fft.ifft(np.fft.fft(z.astype(np.complex128), axis=-1)
                       * H.astype(np.complex128), axis=-1)
    assert snr_db(got, want) >= SNR_DB


def _filter_case(taps, n, seed):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(taps) / taps).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.convolve(x.astype(np.float64), h.astype(np.float64))[:n]
    return h, x, want


@pytest.mark.parametrize("mode", ["whole", "packed", "stream"])
@pytest.mark.parametrize("taps", [17, 129])
@pytest.mark.parametrize("n", [1 << 12, 1 << 16, 1 << 20])
def test_filter_plan_matches_convolution(n, taps, mode):
    from fftlab.plan.filter_plan import FilterPlan

    h, x, want = _filter_case(taps, n, seed=n % 83 + taps)
    plan = FilterPlan(h)
    if mode == "whole":
        got, _ = plan(x, np.zeros(n, np.float32))
    elif mode == "packed":
        assert plan._call_packed_real(jnp.asarray(x)) is not None
        got = plan(x)
    else:
        # eight chunks of unequal lengths
        cuts = np.sort(np.random.default_rng(n).choice(
            np.arange(1, n), 7, replace=False))
        got = np.concatenate([plan.stream(c) for c in np.split(x, cuts)])
    assert np.asarray(got).shape == (n,)
    assert snr_db(got, want) >= SNR_DB


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("frame,hop,n", [
    (256, 64, 1 << 14), (512, 128, 1 << 14), (1024, 256, 1 << 18),
    (2048, 512, 1 << 18), (2048, 512, 1 << 14),
])
def test_stft_split_matches_framed_rfft(frame, hop, n, onesided):
    from fftlab.core.window import get_window
    from fftlab.dsp.stft import stft_split

    x = np.random.default_rng(frame + n).standard_normal(n).astype(
        np.float32)
    Sr, Si = stft_split(jnp.asarray(x), frame, hop, onesided=onesided)
    n_frames = int(Sr.shape[0])
    xp = np.pad(x.astype(np.float64), (0, (n_frames - 1) * hop + frame - n))
    frames = np.lib.stride_tricks.sliding_window_view(xp, frame)[::hop]
    w = np.asarray(get_window("hann", frame), np.float64)
    spec = np.fft.fft(frames[:n_frames] * w, axis=-1)
    want = spec[:, : frame // 2 + 1] if onesided else spec
    assert snr_db(_join(Sr, Si), want) >= SNR_DB


@pytest.mark.parametrize("window", [256, 1024, 2048])
def test_welch_psd_split_matches_periodogram_mean(window):
    from fftlab.core.window import get_window, power_gain
    from fftlab.dsp.spectrum import welch_psd_split

    n = 1 << 16
    x = np.random.default_rng(window).standard_normal(n).astype(np.float32)
    freqs, psd = welch_psd_split(jnp.asarray(x), 1.0, window, 0.5)
    w = np.asarray(get_window("hann", window), np.float64)
    segs = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), window)[:: window // 2]
    p = np.abs(np.fft.rfft(segs * w, axis=-1)) ** 2
    dbl = np.full(window // 2 + 1, 2.0)
    dbl[0] = dbl[-1] = 1.0
    want = p.mean(axis=0) * dbl / (window * power_gain(w))
    assert len(freqs) == window // 2 + 1
    assert snr_db(psd, want) >= SNR_DB


@pytest.mark.parametrize("direction", [FORWARD, INVERSE],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("shape", [(64, 64), (128, 256), (256, 128),
                                   (512, 512), (96, 80), (1024, 1024)],
                         ids=_id)
def test_fft2_split_matches_fft2(shape, direction):
    from fftlab.algos.split_stockham import fft2_split

    z, xr, xi = _planes(shape, seed=shape[0] + shape[1])
    got = _join(*fft2_split(xr, xi, direction))
    zc = z.astype(np.complex128)
    want = np.fft.fft2(zc) if direction == FORWARD else np.fft.ifft2(zc)
    assert snr_db(got, want) >= SNR_DB
