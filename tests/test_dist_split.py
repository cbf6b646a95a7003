"""Split-plane (complex-free) distributed pipelines: must match the
complex versions exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from fftlab.dist.four_step import four_step_fft
from fftlab.dist.four_step_split import four_step_fft_sharded_split
from fftlab.dist.overlap_save_split import overlap_save_filter_sharded_split
from fftlab.dsp.convolution import fft_convolution


class TestFourStepSplit:
    @pytest.mark.parametrize("n", [4096, 65536])
    def test_matches_complex_path(self, mesh8, n):
        rng = np.random.default_rng(n)
        xr = rng.standard_normal(n)
        xi = rng.standard_normal(n)
        yr, yi = four_step_fft_sharded_split(xr, xi, mesh8, axis_name="x")
        got = np.asarray(yr) + 1j * np.asarray(yi)
        want = np.asarray(four_step_fft(xr + 1j * xi))
        np.testing.assert_allclose(got, want, atol=1e-8 * n)

    def test_chunked_overlap_identical(self, mesh8):
        """The comm/compute-overlap form (chunks=K pipelined
        column-stage all_to_alls) is bitwise identical to the
        single-collective form."""
        n = 1 << 14
        rng = np.random.default_rng(9)
        xr = rng.standard_normal(n).astype(np.float32)
        xi = rng.standard_normal(n).astype(np.float32)
        y1 = four_step_fft_sharded_split(xr, xi, mesh8, "x", chunks=1)
        for k in (2, 4):
            yk = four_step_fft_sharded_split(xr, xi, mesh8, "x", chunks=k)
            for a, b in zip(y1, yk):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        with pytest.raises(ValueError):
            four_step_fft_sharded_split(xr, xi, mesh8, "x", chunks=7)

    def test_inverse_roundtrip(self, mesh8):
        from fftlab.core.types import Direction

        rng = np.random.default_rng(1)
        n = 4096
        xr = rng.standard_normal(n)
        xi = rng.standard_normal(n)
        Yr, Yi = four_step_fft_sharded_split(xr, xi, mesh8, "x")
        br, bi = four_step_fft_sharded_split(Yr, Yi, mesh8, "x",
                                             direction=Direction.INVERSE)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-9)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-9)

    def test_matrix_form(self, mesh8):
        rng = np.random.default_rng(2)
        n = 4096
        xr = rng.standard_normal(n).astype(np.float32)
        yr, yi = four_step_fft_sharded_split(
            xr, np.zeros_like(xr), mesh8, "x", flatten=False
        )
        assert yr.shape == (64, 64)

    def test_float32(self, mesh8):
        rng = np.random.default_rng(3)
        n = 65536
        xr = rng.standard_normal(n).astype(np.float32)
        xi = rng.standard_normal(n).astype(np.float32)
        yr, yi = four_step_fft_sharded_split(xr, xi, mesh8, "x")
        got = (np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64))
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        snr = 10 * np.log10(
            np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)
        )
        assert snr > 100.0, f"SNR {snr:.1f}"


class TestOverlapSaveSplit:
    @pytest.mark.parametrize("nh", [7, 65])
    def test_two_channels_for_one(self, mesh8, nh):
        """Two real channels packed as (re, im) both come out filtered."""
        rng = np.random.default_rng(nh)
        n = 8192
        ch0 = rng.standard_normal(n)
        ch1 = rng.standard_normal(n)
        h = rng.standard_normal(nh)
        yr, yi = overlap_save_filter_sharded_split(ch0, ch1, h, mesh8, "x")
        np.testing.assert_allclose(
            np.asarray(yr), np.asarray(fft_convolution(ch0, h))[:n],
            atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(yi), np.asarray(fft_convolution(ch1, h))[:n],
            atol=1e-8,
        )

    def test_batched(self, mesh8):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((3, 4096))
        h = rng.standard_normal(31)
        yr, _ = overlap_save_filter_sharded_split(
            x, np.zeros_like(x), h, mesh8, "x"
        )
        want = np.asarray(fft_convolution(x, h))[..., :4096]
        np.testing.assert_allclose(np.asarray(yr), want, atol=1e-8)

    def test_validation(self, mesh8):
        with pytest.raises(ValueError):
            overlap_save_filter_sharded_split(
                jnp.zeros(64), jnp.zeros(64), jnp.zeros(65), mesh8, "x"
            )


class TestFilterbankSplit:
    def test_matches_per_channel_convolution(self):
        from fftlab.dist.mesh import make_mesh
        from fftlab.dist.overlap_save_split import (
            overlap_save_filterbank_sharded_split,
        )

        mesh = make_mesh({"dp": 2, "sp": 4})
        rng = np.random.default_rng(0)
        c, n, nh = 4, 4096, 31
        x = rng.standard_normal((c, n)).astype(np.float32)
        hb = rng.standard_normal((c, nh)).astype(np.float32)
        got = np.asarray(
            overlap_save_filterbank_sharded_split(x, hb, mesh)
        )
        for ch in range(c):
            want = np.convolve(x[ch].astype(np.float64),
                               hb[ch].astype(np.float64))[:n]
            np.testing.assert_allclose(got[ch], want, atol=1e-3,
                                       err_msg=f"channel {ch}")


class TestFft2Sharded:
    def test_matches_numpy_fft2(self, mesh8):
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        rng = np.random.default_rng(0)
        xr = rng.standard_normal((64, 128))
        xi = rng.standard_normal((64, 128))
        yr, yi = fft2_sharded_split(xr, xi, mesh8, "x")
        got = np.asarray(yr) + 1j * np.asarray(yi)
        want = np.fft.fft2(xr + 1j * xi)
        np.testing.assert_allclose(got, want, atol=1e-8)

    def test_chunked_overlap_identical(self, mesh8):
        """chunks=K (pipelined row-stage all_to_alls) is bitwise
        identical to the single-collective form."""
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        rng = np.random.default_rng(4)
        xr = rng.standard_normal((64, 128)).astype(np.float32)
        xi = rng.standard_normal((64, 128)).astype(np.float32)
        y1 = fft2_sharded_split(xr, xi, mesh8, "x", chunks=1)
        for k in (2, 4):
            yk = fft2_sharded_split(xr, xi, mesh8, "x", chunks=k)
            for a, b in zip(y1, yk):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        with pytest.raises(ValueError):
            fft2_sharded_split(xr, xi, mesh8, "x", chunks=3)

    def test_transposed_out(self, mesh8):
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        rng = np.random.default_rng(1)
        xr = rng.standard_normal((32, 64))
        yr, yi = fft2_sharded_split(xr, np.zeros_like(xr), mesh8, "x",
                                    transposed_out=True)
        got = (np.asarray(yr) + 1j * np.asarray(yi)).T
        want = np.fft.fft2(xr)
        np.testing.assert_allclose(got, want, atol=1e-8)

    def test_inverse_roundtrip(self, mesh8):
        from fftlab.core.types import Direction
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        rng = np.random.default_rng(2)
        xr = rng.standard_normal((32, 32))
        xi = rng.standard_normal((32, 32))
        Yr, Yi = fft2_sharded_split(xr, xi, mesh8, "x")
        br, bi = fft2_sharded_split(Yr, Yi, mesh8, "x",
                                    direction=Direction.INVERSE)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-10)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-10)

    def test_indivisible_raises(self, mesh8):
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        with pytest.raises(ValueError):
            fft2_sharded_split(np.zeros((30, 64)), np.zeros((30, 64)),
                               mesh8, "x")


class TestFft2Mesh2D:
    """Both-axes-distributed 2D FFT (dist.fft2_mesh2d): block-sharded
    over a 2D mesh, each 1D pass a four-step distributed transform."""

    @pytest.fixture(scope="class")
    def mesh2d(self):
        import jax

        return jax.make_mesh((2, 4), ("a", "b"))

    def test_matches_numpy_fft2(self, mesh2d):
        from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split

        rng = np.random.default_rng(0)
        x = rng.standard_normal((64, 128)) + 1j * rng.standard_normal(
            (64, 128))
        yr, yi = fft2_mesh2d_split(
            x.real.astype(np.float32), x.imag.astype(np.float32),
            mesh2d, "a", "b")
        got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
        want = np.fft.fft2(x)
        snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                            / np.sum(np.abs(got - want) ** 2))
        assert snr > 120.0

    def test_inverse_roundtrip(self, mesh2d):
        from fftlab.core.types import Direction
        from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split

        rng = np.random.default_rng(2)
        xr = rng.standard_normal((32, 64)).astype(np.float32)
        xi = rng.standard_normal((32, 64)).astype(np.float32)
        Yr, Yi = fft2_mesh2d_split(xr, xi, mesh2d, "a", "b")
        br, bi = fft2_mesh2d_split(Yr, Yi, mesh2d, "a", "b",
                                   direction=Direction.INVERSE)
        np.testing.assert_allclose(np.asarray(br), xr, atol=2e-5)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=2e-5)

    def test_unflattened_block_form(self, mesh2d):
        """flatten=False keeps the factor matrix sharded
        P(None, c_axis, None, r_axis) — no replication gather — and its
        documented indexing reconstructs the spectrum."""
        from jax.sharding import PartitionSpec as P

        from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split
        from fftlab.dist.four_step import split_n

        R, C = 32, 64
        rng = np.random.default_rng(3)
        x = rng.standard_normal((R, C)) + 1j * rng.standard_normal((R, C))
        wr, wi = fft2_mesh2d_split(
            x.real.astype(np.float32), x.imag.astype(np.float32),
            mesh2d, "a", "b", flatten=False)
        r1, r2 = split_n(R)
        c1, c2 = split_n(C)
        assert wr.shape == (c1, c2, r1, r2)
        assert wr.sharding.spec == P(None, "b", None, "a")
        got = (np.asarray(wr, np.float64)
               + 1j * np.asarray(wi, np.float64)).reshape(C, R).T
        want = np.fft.fft2(x)
        snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                            / np.sum(np.abs(got - want) ** 2))
        assert snr > 120.0

    def test_matches_pencil_decomposition(self, mesh2d):
        """Same transform as the pencil path (different distribution)."""
        import jax

        from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split
        from fftlab.dist.fft2_sharded import fft2_sharded_split

        rng = np.random.default_rng(5)
        xr = rng.standard_normal((32, 64)).astype(np.float32)
        xi = rng.standard_normal((32, 64)).astype(np.float32)
        ar, ai = fft2_mesh2d_split(xr, xi, mesh2d, "a", "b")
        mesh1d = jax.make_mesh((8,), ("x",))
        br, bi = fft2_sharded_split(xr, xi, mesh1d, "x")
        np.testing.assert_allclose(np.asarray(ar), np.asarray(br),
                                   rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(np.asarray(ai), np.asarray(bi),
                                   rtol=1e-4, atol=1e-2)

    def test_indivisible_raises(self, mesh2d):
        from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split

        with pytest.raises(ValueError):
            fft2_mesh2d_split(np.zeros((30, 64), np.float32),
                              np.zeros((30, 64), np.float32),
                              mesh2d, "a", "b")

    def test_batch_axes_validation(self, mesh2d):
        from fftlab.dist.four_step_split import four_step_fft_sharded_split

        xr = np.zeros((4, 64), np.float32)
        with pytest.raises(ValueError):
            four_step_fft_sharded_split(xr, xr, mesh2d, "b",
                                        batch_axes=("a", "a"))
        with pytest.raises(ValueError):
            four_step_fft_sharded_split(xr, xr, mesh2d, "b",
                                        batch_axes=("b",))
        with pytest.raises(ValueError):
            four_step_fft_sharded_split(
                np.zeros((3, 64), np.float32),
                np.zeros((3, 64), np.float32), mesh2d, "b",
                batch_axes=("a",))
