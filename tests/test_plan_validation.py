"""Plan-layer validation and API-robustness tests (the typed-error
analog of the reference's exit-on-fail macros, fft_common.h:117-127)."""

import numpy as np
import pytest

import fftlab
from fftlab.plan.api import plan_dft_1d, plan_dft_2d, plan_r2c_1d
from fftlab.plan.flags import Flags, PlanConfig
from fftlab.plan.planner import estimate_algorithm, measure_algorithm


class TestPlanValidation:
    def test_unknown_algorithm_raises(self):
        with pytest.raises(KeyError):
            fftlab.fft(np.zeros(64, np.complex64), algorithm="warp_drive")

    def test_pow2_only_algorithm_on_composite_raises(self):
        with pytest.raises(Exception):
            np.asarray(fftlab.fft(np.zeros(100, np.complex64),
                                  algorithm="radix2_dit"))

    def test_plan_reuse_is_cached(self):
        p1 = plan_dft_1d(2048)
        p2 = plan_dft_1d(2048)
        assert p1 is p2  # lru-cached plan identity = FFTW plan reuse

    def test_plan_describe(self):
        p = plan_dft_1d(512)
        assert "512" in p.describe() and "FORWARD" in p.describe()
        p.destroy()  # no-op, must not break the cached plan
        assert np.asarray(p.execute(np.ones(512, np.complex64))).shape == (512,)

    def test_r2c_plan_shapes(self):
        p = plan_r2c_1d(256)
        out = np.asarray(p.execute(np.ones(256, np.float32)))
        assert out.shape == (129,)

    def test_2d_plan(self):
        p = plan_dft_2d(16, 32)
        out = np.asarray(p.execute(np.ones((16, 32), np.complex64)))
        assert out.shape == (16, 32)
        assert abs(out[0, 0] - 512) < 1e-3

    def test_measure_mode_records_wisdom(self):
        from fftlab.plan import wisdom

        wisdom.forget()
        name = measure_algorithm(
            128, fftlab.FORWARD, np.complex64, Flags.MEASURE, PlanConfig(),
            batch=2, iters=2,
        )
        assert wisdom.lookup(128, "f32") is not None
        assert wisdom.lookup(128, "f32")["algorithm"] == name
        wisdom.forget()

    def test_wisdom_only_without_wisdom_raises(self):
        from fftlab.plan import wisdom

        wisdom.forget()
        with pytest.raises(RuntimeError):
            measure_algorithm(
                4096, fftlab.FORWARD, np.complex64, Flags.WISDOM_ONLY,
                PlanConfig(),
            )

    def test_estimate_prefers_flagship(self):
        assert estimate_algorithm(4096, PlanConfig()) == "stockham_mxu"
        assert estimate_algorithm(100003, PlanConfig()) == "bluestein"


class TestSplitTuning:
    def test_tune_and_recall(self):
        from fftlab.plan import wisdom
        from fftlab.plan.split_tuning import best_leaf, tune_split_leaf

        wisdom.forget()
        leaf = tune_split_leaf(4096, leaves=(64, 128), batch=1, iters=2)
        assert leaf in (64, 128)
        assert best_leaf(4096) == leaf
        wisdom.forget()
        from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT

        assert best_leaf(4096) == DEFAULT_LEAF_SPLIT

    def test_prime_unreachable_leaves_fall_back(self):
        from fftlab.plan.split_tuning import tune_split_leaf
        from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT

        # 10007 is prime > all leaves: nothing measurable.
        assert tune_split_leaf(10007, leaves=(64, 128),
                               persist=False) == DEFAULT_LEAF_SPLIT

    def test_run_route_rejects_unknown(self):
        import jax.numpy as jnp
        import pytest as _pytest
        from fftlab.plan.dispatch import run_route

        z = jnp.zeros((1, 128), jnp.float32)
        with _pytest.raises(ValueError):
            run_route("bogus", z, z, 1)

    def test_split_plan_estimate_and_execute(self):
        import jax.numpy as jnp
        from fftlab.plan.api import plan_dft_1d_split

        n = 1024
        p = plan_dft_1d_split(n)
        assert p.kind == "c2c_split"
        assert p.algorithm == "einsum"  # CPU route
        rng = np.random.default_rng(3)
        xr = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
        xi = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
        yr, yi = p.execute((xr, xi))
        got = (np.asarray(yr[0], np.float64)
               + 1j * np.asarray(yi[0], np.float64))
        want = np.fft.fft(np.asarray(xr[0], np.float64)
                          + 1j * np.asarray(xi[0], np.float64))
        snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                            / np.sum(np.abs(got - want) ** 2))
        assert snr > 120.0

    def test_split_real_plans_roundtrip(self):
        import jax.numpy as jnp
        from fftlab.plan.api import plan_c2r_1d_split, plan_r2c_1d_split

        n = 1024
        pf = plan_r2c_1d_split(n)
        pi = plan_c2r_1d_split(n)
        assert pf.kind == "r2c_split" and pi.kind == "c2r_split"
        # Route name is backend-dependent (einsum on CPU runners); only
        # the wrapper is asserted exactly.
        assert pf.algorithm.startswith("rfft_split[")
        assert pi.algorithm.startswith("irfft_split[")
        rng = np.random.default_rng(7)
        x = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
        Xr, Xi = pf.execute(x)
        assert Xr.shape == (3, n // 2 + 1)
        want = np.fft.rfft(np.asarray(x, np.float64), axis=-1)
        got = np.asarray(Xr, np.float64) + 1j * np.asarray(Xi, np.float64)
        snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                            / np.sum(np.abs(got - want) ** 2))
        assert snr > 120.0
        y = pi.execute((Xr, Xi))
        snr_rt = 10 * np.log10(
            np.sum(np.asarray(x, np.float64) ** 2)
            / np.sum((np.asarray(y, np.float64)
                      - np.asarray(x, np.float64)) ** 2))
        assert snr_rt > 120.0

    def test_split_real_plan_odd_n(self):
        import jax.numpy as jnp
        from fftlab.plan.api import plan_c2r_1d_split, plan_r2c_1d_split

        n = 15
        x = jnp.asarray(np.random.default_rng(8).standard_normal(n),
                        jnp.float32)
        Xr, Xi = plan_r2c_1d_split(n).execute(x)
        want = np.fft.rfft(np.asarray(x, np.float64))
        got = np.asarray(Xr, np.float64) + 1j * np.asarray(Xi, np.float64)
        np.testing.assert_allclose(got, want, atol=1e-3)
        y = plan_c2r_1d_split(n).execute((Xr, Xi))
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-3)

    def test_split_plan_measure_records_wisdom(self):
        from fftlab.plan import wisdom
        from fftlab.plan.api import plan_dft_1d_split
        from fftlab.plan.flags import Flags

        wisdom.forget()
        p = plan_dft_1d_split(512, flags=Flags.MEASURE, batch=1)
        assert p.algorithm == "einsum"
        assert wisdom.lookup(512, "f32", kind="split") is not None
        wisdom.forget()

    def test_tune_persists_to_file(self, tmp_path, monkeypatch):
        """tune_split_leaf(persist=True) writes the wisdom FILE so a
        later process skips the measurement."""
        import json

        from fftlab.plan import wisdom
        from fftlab.plan.split_tuning import tune_split_leaf

        p = tmp_path / "wisdom.json"
        monkeypatch.setenv("FFTLAB_WISDOM_PATH", str(p))
        wisdom.forget()
        leaf = tune_split_leaf(256, leaves=(64, 128), batch=1, iters=2)
        data = json.loads(p.read_text())
        assert data["split:256:f32"]["algorithm"] == f"leaf={leaf}"
        assert data["split:256:f32"]["platform"] == "cpu"
        wisdom.forget()

    def test_stale_wisdom_algorithm_falls_back(self):
        """A wisdom entry naming a renamed/unknown algorithm must fall
        back to the ESTIMATE heuristic, not KeyError at plan build."""
        from fftlab.plan import wisdom
        from fftlab.plan.api import plan_dft_1d

        wisdom.forget()
        wisdom.record(333, "f32", "renamed_algo", 1.0)
        plan = plan_dft_1d(333)
        assert plan.algorithm != "renamed_algo"
        x = np.random.default_rng(0).standard_normal(333).astype(np.complex64)
        X = plan.execute(x)
        np.testing.assert_allclose(np.asarray(X), np.fft.fft(x),
                                   atol=1e-2)
        wisdom.forget()

    def test_split_plan_wisdom_only_requires_measurement(self):
        import pytest as _pytest
        from fftlab.plan import wisdom
        from fftlab.plan.api import plan_dft_1d_split
        from fftlab.plan.flags import Flags

        wisdom.forget()
        with _pytest.raises(RuntimeError):
            plan_dft_1d_split(2048, flags=Flags.WISDOM_ONLY)

    def test_leaf_wisdom_platform_filtered(self):
        # Wisdom measured on another platform (files travel via
        # export/import) must not be served here.
        from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT
        from fftlab.plan import wisdom
        from fftlab.plan.split_tuning import best_leaf

        wisdom.forget()
        wisdom.record(1024, "f32", "leaf=64", 1.0, kind="split",
                      extra={"platform": "gpu"})
        assert best_leaf(1024) == DEFAULT_LEAF_SPLIT  # this test runs on cpu
        wisdom.record(1024, "f32", "leaf=64", 1.0, kind="split",
                      extra={"platform": "cpu"})
        assert best_leaf(1024) == 64
        wisdom.forget()

    def test_stale_leaf_wisdom_ignored(self):
        # A split entry that names no leaf must fall back to the default.
        from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT
        from fftlab.plan import wisdom
        from fftlab.plan.split_tuning import best_leaf

        wisdom.forget()
        wisdom.record(8192, "f32", "renamed_route", 1.0, kind="split")
        assert best_leaf(8192) == DEFAULT_LEAF_SPLIT
        wisdom.forget()


class TestEdgeSizes:
    @pytest.mark.parametrize("n", [1, 2, 3])
    def test_tiny_transforms(self, n):
        x = np.arange(1, n + 1, dtype=np.complex128)
        got = np.asarray(fftlab.fft(x))
        np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-12)

    def test_n1_split(self):
        from fftlab.algos.split_stockham import fft_split

        yr, yi = fft_split(np.ones(1), np.zeros(1))
        assert float(yr[0]) == 1.0

    def test_registry_four_step(self):
        from fftlab.algos import build_registry

        reg = build_registry()
        assert reg["four_step"].supports(100)
        assert not reg["four_step"].supports(97)  # prime
        x = np.random.default_rng(0).standard_normal(144) * (1 + 0j)
        got = np.asarray(reg["four_step"].fn(x))
        np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-9)


class TestCapsDispatch:
    """plan/dispatch.py: one route-choice point and one executor."""

    def test_cpu_always_einsum(self):
        from fftlab.plan.dispatch import ROUTES, select_split_impl

        assert ROUTES == ("einsum",)
        assert select_split_impl(8192) == "einsum"

    def test_spectral_filter_auto_matches_reference(self):
        import jax.numpy as jnp
        from fftlab.algos.split_stockham import (
            permute_response,
            spectral_filter_split,
        )
        from fftlab.plan.dispatch import spectral_filter_auto

        n = 512
        rng = np.random.default_rng(11)
        xr = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
        xi = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
        hr = rng.standard_normal(n).astype(np.float32)
        hi = rng.standard_normal(n).astype(np.float32)
        want_r, want_i = spectral_filter_split(
            xr, xi, jnp.asarray(hr), jnp.asarray(hi))
        got_r, got_i = spectral_filter_auto(xr, xi, hr, hi)
        np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(got_i), np.asarray(want_i),
                                   atol=1e-3)
        # Pre-permuted H (the plan-time-cached form) gives the same
        # result on the einsum route.
        pr, pi_ = permute_response(hr, hi, n)
        got2_r, got2_i = spectral_filter_auto(xr, xi, hr, hi,
                                              permuted=(pr, pi_))
        np.testing.assert_allclose(np.asarray(got2_r), np.asarray(got_r),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got2_i), np.asarray(got_i),
                                   atol=1e-5)

    def test_auto_route_matches_oracle(self):
        # The auto route must run the einsum path and match numpy.
        import jax.numpy as jnp
        import numpy as np
        from fftlab.plan.dispatch import fft_split_auto

        rng = np.random.default_rng(3)
        xr = jnp.asarray(rng.standard_normal((2, 512)), jnp.float32)
        xi = jnp.asarray(rng.standard_normal((2, 512)), jnp.float32)
        yr, yi = fft_split_auto(xr, xi)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        want = np.fft.fft(np.asarray(xr) + 1j * np.asarray(xi), axis=-1)
        assert np.allclose(got, want, atol=1e-3)
