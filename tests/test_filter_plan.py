"""FilterPlan serving API: whole-signal, streaming continuity, mesh."""

import numpy as np
import pytest

from fftlab.dsp.convolution import fft_convolution
from fftlab.plan.filter_plan import FilterPlan


class TestFilterPlan:
    def test_whole_signal_matches_convolution(self):
        rng = np.random.default_rng(0)
        n, nh = 4096, 33
        x = rng.standard_normal(n)
        h = rng.standard_normal(nh)
        plan = FilterPlan(h)
        got = np.asarray(plan(x))
        want = np.asarray(fft_convolution(x, h))[:n]
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_two_channels(self):
        rng = np.random.default_rng(1)
        n, nh = 2048, 17
        a = rng.standard_normal(n)
        b = rng.standard_normal(n)
        h = rng.standard_normal(nh)
        plan = FilterPlan(h)
        ya, yb = plan(a, b)
        np.testing.assert_allclose(
            np.asarray(ya), np.asarray(fft_convolution(a, h))[:n], atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(yb), np.asarray(fft_convolution(b, h))[:n], atol=1e-4)

    @pytest.mark.parametrize("n", [4096, 4097, 5000])
    def test_packed_real_matches_unpacked(self, n):
        """The r2c halves-packing fast path equals the two-plane path
        (and the convolution oracle) for even/odd/awkward lengths."""
        rng = np.random.default_rng(7)
        nh = 33
        x = rng.standard_normal(n)
        h = rng.standard_normal(nh)
        plan = FilterPlan(h)
        import jax.numpy as jnp

        assert plan._call_packed_real(jnp.asarray(x, jnp.float32)) is not None
        got = np.asarray(plan(x))
        assert got.shape == (n,)
        # Unpacked route: passing an explicit zero imag plane bypasses
        # the packing branch.
        want_r, _ = plan(x, np.zeros(n))
        np.testing.assert_allclose(got, np.asarray(want_r), atol=1e-4)
        want = np.asarray(fft_convolution(x, h))[:n]
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_packed_real_skips_short_signals(self):
        plan = FilterPlan(np.ones(9) / 9.0)
        import jax.numpy as jnp

        assert plan._call_packed_real(jnp.ones(64, jnp.float32)) is None

    def test_streaming_continuity(self):
        """concat(stream(chunks)) == offline filter — exactly."""
        rng = np.random.default_rng(2)
        n, nh = 6000, 65
        x = rng.standard_normal(n).astype(np.float32)
        h = rng.standard_normal(nh)
        plan = FilterPlan(h)
        chunks = [x[0:1000], x[1000:1500], x[1500:4096], x[4096:6000]]
        got = np.concatenate([plan.stream(c) for c in chunks])
        plan.reset()
        want = np.asarray(plan(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_reset_restarts_stream(self):
        rng = np.random.default_rng(3)
        h = rng.standard_normal(9)
        plan = FilterPlan(h)
        c = rng.standard_normal(512).astype(np.float32)
        y1 = plan.stream(c)
        plan.reset()
        y2 = plan.stream(c)
        np.testing.assert_allclose(y1, y2)

    def test_from_filter_params(self):
        from fftlab.dsp.filtering import FilterParams, FilterType

        p = FilterParams(FilterType.LOWPASS, 0.1, sample_rate=1.0,
                         transition_width=0.02)
        plan = FilterPlan(p, num_taps=65)
        assert plan.nh == 65
        rng = np.random.default_rng(4)
        y = np.asarray(plan(rng.standard_normal(1024)))
        assert y.shape == (1024,) and np.all(np.isfinite(y))

    def test_mesh_plan(self, mesh8):
        rng = np.random.default_rng(5)
        n, nh = 8192, 21
        x = rng.standard_normal(n)
        h = rng.standard_normal(nh)
        plan = FilterPlan(h, mesh=mesh8, time_axis="x")
        assert "mesh[x]" in plan.describe()
        got = np.asarray(plan(x))
        want = np.asarray(fft_convolution(x, h))[:n]
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_validation(self):
        with pytest.raises(ValueError):
            FilterPlan(np.zeros((2, 3)))
        with pytest.raises(ValueError):
            FilterPlan(np.zeros(100), fft_size=128)
        plan = FilterPlan(np.ones(5))
        with pytest.raises(ValueError):
            plan.stream(np.zeros((2, 10)))

    def test_long_taps_filter_correctly(self):
        """A 16K-tap filter (halo of a whole 16K block) filters correctly
        through the block path."""
        plan = FilterPlan(np.ones(16384, np.float32) / 16384.0)
        rng = np.random.default_rng(5)
        x = rng.standard_normal(1 << 15).astype(np.float32)
        got = np.asarray(plan(x))
        want = np.asarray(fft_convolution(x, np.ones(16384) / 16384.0))
        np.testing.assert_allclose(got, want[: 1 << 15], atol=1e-3)
