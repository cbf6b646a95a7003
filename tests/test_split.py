"""Tests for the split re/im device path (algos/split_stockham.py):
must match the complex-dtype path and the numpy oracle exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from fftlab.algos.split_stockham import (
    fft_split,
    spectral_filter_split_fused,
    ifft_split,
    irfft_split,
    rfft_split,
    spectral_filter_split,
    to_split,
    from_split,
)
from fftlab.core.types import Direction


def _rand(rng, shape):
    return rng.standard_normal(shape), rng.standard_normal(shape)


SIZES = [1, 2, 4, 8, 64, 128, 1024, 4096, 12, 360, 1000]


class TestFftSplit:
    @pytest.mark.parametrize("n", SIZES)
    def test_forward_matches_numpy(self, n):
        rng = np.random.default_rng(n)
        xr, xi = _rand(rng, (3, n))
        yr, yi = fft_split(xr, xi)
        got = from_split(yr, yi)
        want = np.fft.fft(xr + 1j * xi)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(n, 8))

    @pytest.mark.parametrize("n", [8, 1024, 360])
    def test_roundtrip(self, n):
        rng = np.random.default_rng(n + 1)
        xr, xi = _rand(rng, (n,))
        Yr, Yi = fft_split(xr, xi)
        br, bi = ifft_split(Yr, Yi)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-10)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-10)

    def test_float32(self):
        rng = np.random.default_rng(7)
        n = 16384
        xr = rng.standard_normal((2, n)).astype(np.float32)
        xi = rng.standard_normal((2, n)).astype(np.float32)
        got = from_split(*fft_split(xr, xi))
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        snr = 10 * np.log10(
            np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)
        )
        assert snr > 100.0, f"float32 SNR {snr:.1f} dB"

    def test_to_from_split(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
        xr, xi = to_split(x)
        np.testing.assert_allclose(from_split(xr, xi), x)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            fft_split(jnp.zeros(8), jnp.zeros(4))


class TestRfftSplit:
    @pytest.mark.parametrize("n", [4, 16, 256, 1024, 9, 15])
    def test_matches_numpy_rfft(self, n):
        rng = np.random.default_rng(n + 2)
        x = rng.standard_normal((2, n))
        Xr, Xi = rfft_split(x)
        got = from_split(Xr, Xi)
        np.testing.assert_allclose(got, np.fft.rfft(x), atol=1e-10)

    @pytest.mark.parametrize("n", [4, 16, 256, 10])
    def test_irfft_roundtrip(self, n):
        rng = np.random.default_rng(n + 3)
        x = rng.standard_normal((2, n))
        Xr, Xi = rfft_split(x)
        back = irfft_split(Xr, Xi, n=n)
        np.testing.assert_allclose(np.asarray(back), x, atol=1e-10)

    @pytest.mark.parametrize("n", [8, 64, 1024, 20])
    def test_paired_unpack_covers_every_bin(self, n):
        """The paired Hermitian unpack (m even: bins k and m-k emitted
        from one E/WO computation, Z read once) must agree bin-for-bin
        with numpy — including the seam bins 0, m/2, m that the pairing
        special-cases. n=20 (m=10 odd) exercises the fallback path."""
        rng = np.random.default_rng(n + 11)
        x = rng.standard_normal((3, n))
        Xr, Xi = rfft_split(x)
        got = from_split(Xr, Xi)
        want = np.fft.rfft(x)
        np.testing.assert_allclose(got, want, atol=1e-10)
        # Nyquist and DC must be exactly real
        np.testing.assert_allclose(np.asarray(Xi)[..., 0], 0.0, atol=1e-10)
        if n % 2 == 0:
            np.testing.assert_allclose(np.asarray(Xi)[..., -1], 0.0,
                                       atol=1e-10)
        back = irfft_split(Xr, Xi, n=n)
        np.testing.assert_allclose(np.asarray(back), x, atol=1e-10)


class TestSpectralFilterSplit:
    def test_matches_complex_sandwich(self):
        rng = np.random.default_rng(9)
        n = 1024
        xr, xi = _rand(rng, (2, n))
        H = np.fft.fft(rng.standard_normal(n))
        yr, yi = spectral_filter_split(
            xr, xi, jnp.asarray(H.real), jnp.asarray(H.imag)
        )
        got = from_split(yr, yi)
        want = np.fft.ifft(np.fft.fft(xr + 1j * xi) * H)
        np.testing.assert_allclose(got, want, atol=1e-9)


class TestFusedFilter:
    @pytest.mark.parametrize("n", [1024, 4096, 131072])
    def test_matches_oracle(self, n):
        rng = np.random.default_rng(n)
        xr = rng.standard_normal((2, n)).astype(np.float32)
        xi = rng.standard_normal((2, n)).astype(np.float32)
        H = np.fft.fft(rng.standard_normal(n))
        yr, yi = spectral_filter_split_fused(
            xr, xi,
            jnp.asarray(H.real.astype(np.float32)),
            jnp.asarray(H.imag.astype(np.float32)),
        )
        got = from_split(yr, yi)
        want = np.fft.ifft(
            np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64)) * H
        )
        snr = 10 * np.log10(
            np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)
        )
        assert snr > 110.0, f"n={n}: SNR {snr:.1f} dB"

    def test_single_factor_falls_back(self):
        rng = np.random.default_rng(1)
        n = 64  # single leaf factor
        xr = rng.standard_normal((n,)).astype(np.float32)
        xi = np.zeros(n, dtype=np.float32)
        yr, yi = spectral_filter_split_fused(
            xr, xi, np.ones(n, np.float32), np.zeros(n, np.float32)
        )
        np.testing.assert_allclose(np.asarray(yr), xr, atol=1e-4)

    def test_digitrev_bins_is_permutation(self):
        from fftlab.algos.split_stockham import digitrev_bins

        for factors in [(4, 8), (8, 4, 2), (64, 64, 32)]:
            b = digitrev_bins(factors)
            assert sorted(b) == list(range(int(np.prod(factors))))

    def test_digitrev_roundtrip_identity(self):
        from fftlab.algos.split_stockham import (
            _fft_split_digitrev,
            _ifft_split_from_digitrev,
        )
        from fftlab.algos.stockham import plan_factors
        from fftlab.core.types import FORWARD

        rng = np.random.default_rng(2)
        n = 8192
        factors = plan_factors(n, 128)
        xr = rng.standard_normal((n,)).astype(np.float64)
        xi = rng.standard_normal((n,)).astype(np.float64)
        Yr, Yi = _fft_split_digitrev(jnp.asarray(xr), jnp.asarray(xi),
                                     FORWARD, factors)
        br, bi = _ifft_split_from_digitrev(Yr, Yi, FORWARD, factors)
        np.testing.assert_allclose(np.asarray(br) / n, xr, atol=1e-10)
        np.testing.assert_allclose(np.asarray(bi) / n, xi, atol=1e-10)

    def test_digitrev_layout_matches_bins(self):
        from fftlab.algos.split_stockham import (
            _fft_split_digitrev,
            digitrev_bins,
        )
        from fftlab.algos.stockham import plan_factors
        from fftlab.core.types import FORWARD

        rng = np.random.default_rng(3)
        n = 2048
        factors = plan_factors(n, 32)  # multiple unequal factors
        x = rng.standard_normal(n)
        Yr, Yi = _fft_split_digitrev(
            jnp.asarray(x), jnp.asarray(np.zeros(n)), FORWARD, factors
        )
        got = np.asarray(Yr) + 1j * np.asarray(Yi)
        want = np.fft.fft(x)[digitrev_bins(factors)]
        np.testing.assert_allclose(got, want, atol=1e-8)


class TestFft2Split:
    def test_matches_numpy_fft2(self):
        from fftlab.algos.split_stockham import fft2_split

        rng = np.random.default_rng(0)
        xr = rng.standard_normal((2, 64, 128)).astype(np.float64)
        xi = rng.standard_normal((2, 64, 128)).astype(np.float64)
        yr, yi = fft2_split(xr, xi)
        got = from_split(yr, yi)
        want = np.fft.fft2(xr + 1j * xi)
        np.testing.assert_allclose(got, want, atol=1e-8)

    def test_inverse_roundtrip(self):
        from fftlab.algos.split_stockham import fft2_split
        from fftlab.core.types import Direction

        rng = np.random.default_rng(1)
        xr = rng.standard_normal((32, 32))
        xi = rng.standard_normal((32, 32))
        Yr, Yi = fft2_split(xr, xi)
        br, bi = fft2_split(Yr, Yi, Direction.INVERSE)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-10)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-10)

    def test_routed_matches_unrouted(self):
        """route=True sends each axis through the capability dispatch;
        forward and inverse compose to the same result and scaling."""
        from fftlab.algos.split_stockham import fft2_split
        from fftlab.core.types import Direction

        rng = np.random.default_rng(3)
        xr = rng.standard_normal((2, 64, 128)).astype(np.float32)
        xi = rng.standard_normal((2, 64, 128)).astype(np.float32)
        yr, yi = fft2_split(xr, xi, route=True)
        br, bi = fft2_split(xr, xi, route=False)
        np.testing.assert_allclose(np.asarray(yr), np.asarray(br),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(np.asarray(yi), np.asarray(bi),
                                   rtol=1e-5, atol=1e-3)
        zr, zi = fft2_split(yr, yi, Direction.INVERSE, route=True)
        np.testing.assert_allclose(np.asarray(zr), xr, atol=1e-4)
        np.testing.assert_allclose(np.asarray(zi), xi, atol=1e-4)


class TestBluesteinSplit:
    @pytest.mark.parametrize("n", [7, 97, 251, 360, 1000, 100003])
    def test_matches_numpy(self, n):
        from fftlab.algos.bluestein import bluestein_fft_split

        rng = np.random.default_rng(n)
        xr = rng.standard_normal(n)
        xi = rng.standard_normal(n)
        yr, yi = bluestein_fft_split(xr, xi)
        got = from_split(yr, yi)
        want = np.fft.fft(xr + 1j * xi)
        snr = 10 * np.log10(
            np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)
        )
        assert snr > 200.0, f"n={n}: SNR {snr:.1f}"  # float64 regime

    def test_float32_prime(self):
        from fftlab.algos.bluestein import bluestein_fft_split

        rng = np.random.default_rng(0)
        n = 10007
        xr = rng.standard_normal(n).astype(np.float32)
        xi = rng.standard_normal(n).astype(np.float32)
        yr, yi = bluestein_fft_split(xr, xi)
        got = from_split(yr, yi)
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        snr = 10 * np.log10(
            np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)
        )
        assert snr > 95.0, f"SNR {snr:.1f}"

    def test_inverse_roundtrip(self):
        from fftlab.algos.bluestein import bluestein_fft_split
        from fftlab.core.types import Direction

        rng = np.random.default_rng(1)
        n = 97
        xr = rng.standard_normal(n)
        xi = rng.standard_normal(n)
        Yr, Yi = bluestein_fft_split(xr, xi)
        br, bi = bluestein_fft_split(Yr, Yi, Direction.INVERSE)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-10)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-10)
