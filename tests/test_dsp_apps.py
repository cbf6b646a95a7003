"""Tests for the application layer: image pipeline, pitch detection,
analyzer, io, plotting (reference applications/ + examples/ parity)."""


import jax.numpy as jnp
import numpy as np
import pytest

from fftlab.dsp.analyzer import (
    AnalyzerConfig,
    RealtimeAnalyzer,
    analyze_peaks,
    analyze_spectrum,
    bin_to_freq,
    freq_to_bin,
)
from fftlab.dsp.image import (
    apply_frequency_mask,
    detect_edges,
    gaussian_lowpass_mask,
    generate_2d_gaussian,
    generate_2d_rect,
    generate_2d_sinusoid,
    highpass_filter_image,
    ideal_lowpass_mask,
    log_magnitude_spectrum,
    lowpass_filter_image,
)
from fftlab.dsp.pitch import (
    detect_pitch,
    freq_to_note,
    harmonic_product_spectrum,
    note_table,
    pitch_autocorrelation,
    pitch_spectral_peak,
)
from fftlab.utils.io import (
    export_gnuplot_script,
    load_complex_signal,
    load_signal_npz,
    save_complex_signal,
    save_signal_npz,
)
from fftlab.utils.plotting import ascii_image, ascii_spectrum
from fftlab.utils.signals import frequency_shift, generate_sine, zero_pad


class TestImage:
    def test_lowpass_removes_high_freq(self):
        img = generate_2d_sinusoid(64, 64, 2, 2) + generate_2d_sinusoid(64, 64, 20, 20)
        out = np.asarray(lowpass_filter_image(img, cutoff=6.0))
        want = generate_2d_sinusoid(64, 64, 2, 2)
        np.testing.assert_allclose(out, want, atol=1e-6)

    def test_highpass_removes_low_freq(self):
        img = generate_2d_sinusoid(64, 64, 2, 2) + generate_2d_sinusoid(64, 64, 20, 20)
        out = np.asarray(highpass_filter_image(img, cutoff=6.0))
        want = generate_2d_sinusoid(64, 64, 20, 20)
        np.testing.assert_allclose(out, want, atol=1e-6)

    def test_gaussian_mask_range(self):
        m = gaussian_lowpass_mask(32, 32, 4.0)
        assert m[0, 0] == 1.0
        assert (m >= 0).all() and (m <= 1).all()

    def test_identity_mask_roundtrip(self):
        rng = np.random.default_rng(0)
        img = rng.standard_normal((16, 16))
        out = np.asarray(apply_frequency_mask(img, np.ones((16, 16))))
        np.testing.assert_allclose(out, img, atol=1e-10)

    def test_edges_of_rect_highlight_boundaries(self):
        img = generate_2d_rect(64, 64, 16, 16)
        e = np.asarray(detect_edges(img, cutoff=4.0))
        interior = e[28:36, 28:36].mean()
        border = e[23:25, 24:40].mean()
        assert border > interior

    def test_log_magnitude_shape(self):
        img = generate_2d_gaussian(32, 32, 4.0)
        s = np.asarray(log_magnitude_spectrum(img))
        assert s.shape == (32, 32)
        # Zero-frequency is centered after fftshift.
        assert s.argmax() == 16 * 32 + 16

    def test_mask_radius_wraps_negative_freqs(self):
        m = ideal_lowpass_mask(16, 16, 2.0)
        assert m[0, 0] == 1.0 and m[0, 15] == 1.0 and m[15, 0] == 1.0
        assert m[8, 8] == 0.0


class TestPitch:
    def test_note_table(self):
        t = note_table()
        assert len(t) == 97
        assert t[0][0] == "C0" and abs(t[0][1] - 16.3516) < 1e-3
        assert t[57] == ("A4", 440.0)
        assert t[96][0] == "C8"

    def test_freq_to_note(self):
        name, cents = freq_to_note(440.0)
        assert name == "A4" and abs(cents) < 1e-9
        name, cents = freq_to_note(446.0)
        assert name == "A4" and 20 < cents < 30

    @pytest.mark.parametrize("f0", [110.0, 220.0, 441.0])
    def test_spectral_peak(self, f0):
        fs, n = 8192.0, 4096
        x = generate_sine(n, f0, fs)
        got = float(np.asarray(pitch_spectral_peak(x, fs)))
        assert abs(got - f0) < 1.0

    def test_hps_rejects_harmonics(self):
        fs, n = 8192.0, 4096
        t = np.arange(n) / fs
        # Fundamental weaker than its harmonics — HPS must still find f0.
        x = (0.4 * np.sin(2 * np.pi * 200 * t)
             + 1.0 * np.sin(2 * np.pi * 400 * t)
             + 0.8 * np.sin(2 * np.pi * 600 * t))
        got = float(np.asarray(harmonic_product_spectrum(x, fs)))
        assert abs(got - 200.0) < 3.0

    def test_autocorrelation_pitch(self):
        fs, n = 8192.0, 4096
        x = generate_sine(n, 256.0, fs)
        got = float(np.asarray(pitch_autocorrelation(x, fs)))
        assert abs(got - 256.0) < 2.0

    def test_detect_pitch_combined(self):
        fs, n = 8192.0, 4096
        x = generate_sine(n, 330.0, fs)
        r = detect_pitch(x, fs)
        assert abs(r["pitch"] - 330.0) < 2.0
        assert r["confidence"] >= 2 / 3
        assert r["note"] == "E4"

    def test_batched_frames(self):
        fs, n = 8192.0, 2048
        frames = np.stack([generate_sine(n, f, fs) for f in (110, 220, 440)])
        got = np.asarray(pitch_spectral_peak(frames, fs))
        np.testing.assert_allclose(got, [110, 220, 440], atol=1.5)


class TestAnalyzer:
    def test_bin_freq_roundtrip(self):
        assert freq_to_bin(bin_to_freq(100, 2048, 44100.0), 2048, 44100.0) == 100

    def test_analyze_spectrum_amplitude(self):
        fs, n = 8192.0, 2048
        x = 0.5 * generate_sine(n, 512.0, fs)
        freqs, mag = analyze_spectrum(x, fs)
        k = int(np.argmax(np.asarray(mag)))
        assert abs(freqs[k] - 512.0) < fs / n
        assert abs(float(mag[k]) - 0.5) < 0.05

    def test_find_peaks_sorted(self):
        fs, n = 8192.0, 4096
        t = np.arange(n) / fs
        x = (1.0 * np.sin(2 * np.pi * 440 * t)
             + 0.6 * np.sin(2 * np.pi * 554.37 * t)
             + 0.3 * np.sin(2 * np.pi * 659.25 * t))
        peaks = analyze_peaks(x, fs, num_peaks=3)
        assert len(peaks) == 3
        assert peaks[0].magnitude >= peaks[1].magnitude >= peaks[2].magnitude
        assert abs(peaks[0].freq - 440.0) < 2.0
        assert peaks[0].note == "A4"

    def test_streaming_matches_config(self):
        cfg = AnalyzerConfig(fft_size=512, hop=128, sample_rate=8192.0,
                             averaging=2)
        an = RealtimeAnalyzer(cfg)
        x = generate_sine(4096, 1024.0, 8192.0)
        out = None
        for i in range(0, 4096, 256):
            out = an.process(x[i : i + 256])
        assert out is not None and out.shape == (257,)
        peaks = an.peaks()
        assert abs(peaks[0].freq - 1024.0) < 8192.0 / 512

    def test_short_chunk_returns_none(self):
        an = RealtimeAnalyzer(AnalyzerConfig(fft_size=512, hop=128))
        assert an.process(np.zeros(16)) is None

    def test_process_matches_host_framing_oracle(self):
        """process() frames on device (stft_split); the magnitudes must
        equal the straightforward host framing + windowed rfft."""
        from fftlab.core.window import get_window

        cfg = AnalyzerConfig(fft_size=256, hop=128, averaging=1)
        an = RealtimeAnalyzer(cfg)
        rng = np.random.default_rng(11)
        x = rng.standard_normal(1024).astype(np.float32)
        got = an.process(x)
        w = get_window(cfg.window, cfg.fft_size)
        n_frames = (1024 - cfg.fft_size) // cfg.hop + 1
        frames = np.stack([x[i * cfg.hop : i * cfg.hop + cfg.fft_size]
                           for i in range(n_frames)])
        want = np.abs(np.fft.rfft(frames * w, axis=-1))
        # averaging=1 -> EMA carry equals the LAST frame's magnitudes
        np.testing.assert_allclose(got, want[-1], atol=2e-3)


class TestIO:
    def test_text_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        x = rng.standard_normal(32) + 1j * rng.standard_normal(32)
        p = str(tmp_path / "sig.txt")
        save_complex_signal(p, x, comment="test")
        got = load_complex_signal(p)
        np.testing.assert_allclose(got, x, atol=1e-15)

    def test_npz_roundtrip(self, tmp_path):
        p = str(tmp_path / "sig.npz")
        save_signal_npz(p, re=np.arange(4.0), im=np.ones(4))
        z = load_signal_npz(p)
        np.testing.assert_array_equal(z["re"], np.arange(4.0))

    def test_gnuplot_script(self, tmp_path):
        p = str(tmp_path / "plot.gp")
        export_gnuplot_script(p, "sig.txt", title="T")
        s = open(p).read()
        assert "sig.txt" in s and "using 1:4" in s

    def test_malformed_row_raises(self, tmp_path):
        p = str(tmp_path / "bad.txt")
        open(p, "w").write("0 1\n")
        with pytest.raises(ValueError):
            load_complex_signal(p)


class TestPlotting:
    def test_ascii_spectrum(self):
        s = ascii_spectrum(np.array([0.0, 1.0, 0.5, 0.0]), n_bins=4, width=10)
        lines = s.split("\n")
        assert len(lines) == 4
        assert lines[1].count("#") == 10

    def test_ascii_image(self):
        s = ascii_image(np.eye(8), width=8, height=8)
        assert len(s.split("\n")) == 8

    def test_bad_input_raises(self):
        with pytest.raises(ValueError):
            ascii_spectrum(np.zeros((2, 2)))
        with pytest.raises(ValueError):
            ascii_image(np.zeros(4))


class TestSignalHelpers:
    def test_zero_pad(self):
        y = zero_pad(np.ones(4), 8)
        assert y.shape == (8,) and y[4:].sum() == 0
        with pytest.raises(ValueError):
            zero_pad(np.ones(8), 4)

    def test_frequency_shift(self):
        fs, n = 1024.0, 1024
        x = generate_sine(n, 100.0, fs).astype(np.complex128)
        y = frequency_shift(x, 50.0, fs)
        Y = np.fft.fft(y)
        assert abs(np.argmax(np.abs(Y)) - 150) <= 1


class TestSplitAnalysis:
    def test_stft_split_matches_complex_path(self):
        from fftlab.dsp.stft import stft_split
        from fftlab.core.window import hann

        rng = np.random.default_rng(0)
        n, fft_size, hop = 8192, 512, 128
        x = rng.standard_normal(n).astype(np.float32)
        Xr, Xi = stft_split(x, fft_size, hop)
        got = np.asarray(Xr) + 1j * np.asarray(Xi)
        n_frames = (n - fft_size) // hop + 1
        w = hann(fft_size)
        want = np.stack([
            np.fft.rfft(x[k * hop : k * hop + fft_size].astype(np.float64) * w)
            for k in range(n_frames)
        ])
        assert got.shape == want.shape
        snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                            / np.sum(np.abs(got - want) ** 2))
        assert snr > 110.0

    def test_stft_split_validation(self):
        from fftlab.dsp.stft import stft_split

        with pytest.raises(ValueError):
            stft_split(np.zeros((2, 100), np.float32))

    def test_welch_split_matches_welch(self):
        from fftlab.dsp.spectrum import welch_psd, welch_psd_split

        rng = np.random.default_rng(1)
        x = rng.standard_normal(8192).astype(np.float32)
        f1, p1 = welch_psd_split(x, sample_rate=100.0, window_size=256)
        f2, p2 = welch_psd(x, sample_rate=100.0, window_size=256)
        np.testing.assert_allclose(f1, f2)
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2),
                                   rtol=1e-4, atol=1e-8)

    def test_autocorrelation_split_matches(self):
        from fftlab.dsp.spectrum import (
            autocorrelation,
            autocorrelation_split,
        )

        rng = np.random.default_rng(2)
        x = rng.standard_normal(1500).astype(np.float32)
        got = np.asarray(autocorrelation_split(x))
        want = np.asarray(autocorrelation(x))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        assert abs(got[0] - 1.0) < 1e-5

    def test_cross_correlation_split_matches(self):
        from fftlab.dsp.spectrum import (
            cross_correlation,
            cross_correlation_split,
        )

        rng = np.random.default_rng(3)
        n = 1000
        x = rng.standard_normal(n).astype(np.float32)
        y = np.roll(x, 17) + 0.1 * rng.standard_normal(n).astype(np.float32)
        got = np.asarray(cross_correlation_split(x, y))
        want = np.asarray(cross_correlation(x, y))
        assert got.shape == (2 * n - 1,)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)
        # the shift shows up at lag +17 (zero lag at index n-1)
        assert np.argmax(got) == (n - 1) + 17

    def test_coherence_split_matches(self):
        from fftlab.dsp.spectrum import coherence, coherence_split

        rng = np.random.default_rng(4)
        n = 4096
        x = rng.standard_normal(n).astype(np.float32)
        y = x + 0.5 * rng.standard_normal(n).astype(np.float32)
        f1, c1 = coherence_split(x, y, sample_rate=10.0, window_size=256)
        f2, c2 = coherence(x, y, sample_rate=10.0, window_size=256)
        np.testing.assert_allclose(f1, f2)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                                   rtol=1e-3, atol=1e-4)
        c = np.asarray(c1)
        assert np.all(c >= 0) and np.all(c <= 1 + 1e-5)


class TestConvolutionSplit:
    def test_linear_convolution_matches_numpy(self):
        import jax.numpy as jnp
        from fftlab.dsp.convolution import fft_convolution_split

        rng = np.random.default_rng(77)
        x = rng.standard_normal(5000).astype(np.float32)
        h = rng.standard_normal(129).astype(np.float32)
        yr, yi = fft_convolution_split(
            jnp.asarray(x), jnp.zeros(5000, jnp.float32), jnp.asarray(h)
        )
        want = np.convolve(x.astype(np.float64), h.astype(np.float64))
        assert yr.shape[-1] == 5000 + 129 - 1
        np.testing.assert_allclose(np.asarray(yr), want, atol=5e-3)
        np.testing.assert_allclose(np.asarray(yi), 0.0, atol=5e-3)

    def test_complex_signal(self):
        import jax.numpy as jnp
        from fftlab.dsp.convolution import fft_convolution_split

        rng = np.random.default_rng(78)
        xr = rng.standard_normal(777).astype(np.float32)
        xi = rng.standard_normal(777).astype(np.float32)
        h = rng.standard_normal(33).astype(np.float32)
        yr, yi = fft_convolution_split(jnp.asarray(xr), jnp.asarray(xi),
                                       jnp.asarray(h))
        want = np.convolve(xr + 1j * xi, h.astype(np.float64))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, want, atol=5e-3)
