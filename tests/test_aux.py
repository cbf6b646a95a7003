"""Tests for auxiliary subsystems: tracing, multihost glue, low-precision
experiments, wisdom persistence (SURVEY.md §5 coverage)."""

import time

import numpy as np
import pytest

from fftlab.algos.lowprec import fft_split_lowprec, snr_vs_oracle
from fftlab.dist.multihost import (
    ensure_initialized,
    host_local_mesh_axes,
    process_info,
)
from fftlab.utils.trace import Timer, span


class TestTrace:
    def test_timer(self):
        t = Timer()
        t.start()
        time.sleep(0.01)
        dt = t.stop()
        assert 0.005 < dt < 1.0
        assert t.elapsed_ms >= 5.0
        assert len(t.laps) == 1

    def test_span_records(self):
        timers = {}
        with span("work", timers, sync=False):
            time.sleep(0.005)
        assert "work" in timers and timers["work"].total_s > 0


class TestMultihost:
    def test_single_host_noop(self):
        assert ensure_initialized() is False  # no coordinator configured

    def test_process_info(self):
        info = process_info()
        assert info["process_count"] == 1
        assert info["local_devices"] == info["global_devices"] == 8

    def test_mesh_axes(self):
        axes = host_local_mesh_axes()
        assert axes["dp"] * axes["sp"] == 8


class TestLowPrec:
    def test_modes_match_oracle_on_cpu(self):
        # The CPU runs Precision.DEFAULT in float32 too (TF32 is a GPU
        # tensor-core format) — both modes are float32-accurate here.
        r = snr_vs_oracle(n=512, modes=("f32", "tf32"))
        assert r["f32"] > 100 and r["tf32"] > 100
        if "q15" in r:
            assert 20 < r["q15"] < 60  # the Q15-class regime

    def test_bad_mode_raises(self):
        with pytest.raises(ValueError):
            fft_split_lowprec(np.zeros(8), np.zeros(8), mode="fp4")

    def test_explicit_precision_plumbs_through(self):
        import jax

        from fftlab.algos.split_stockham import fft_split

        rng = np.random.default_rng(0)
        xr = rng.standard_normal((256,)).astype(np.float32)
        xi = rng.standard_normal((256,)).astype(np.float32)
        yr, yi = fft_split(xr, xi, precision=jax.lax.Precision.DEFAULT)
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        assert np.max(np.abs(got - want)) < 1e-2


class TestReviewRegressions:
    def test_get_window_returns_private_copy(self):
        from fftlab.core.window import get_window

        w = get_window("hann", 64)
        w[0] = 999.0
        assert get_window("hann", 64)[0] != 999.0

    def test_goertzel_inverse_scaling(self):
        """Single-bin evaluators follow the package convention:
        inverse is 1/n scaled (regression: factor-n too large)."""
        from fftlab.algos.dft import dft_bin, goertzel, naive_dft
        from fftlab.core.types import INVERSE

        rng = np.random.default_rng(3)
        x = rng.standard_normal(8) + 1j * rng.standard_normal(8)
        want = np.asarray(naive_dft(x, INVERSE))[2]
        np.testing.assert_allclose(complex(goertzel(x, 2, INVERSE)), want,
                                   atol=1e-10)
        np.testing.assert_allclose(complex(dft_bin(x, 2, INVERSE)), want,
                                   atol=1e-10)

    def test_analyze_spectrum_dc_not_doubled(self):
        from fftlab.dsp.analyzer import analyze_spectrum

        _, mag = analyze_spectrum(np.full(256, 0.5), 1000.0,
                                  window="rectangular")
        np.testing.assert_allclose(float(mag[0]), 0.5, atol=1e-6)

    def test_framing_env_validated(self, monkeypatch):
        from fftlab.core.framing import frame_signal_strided

        monkeypatch.setenv("FFTLAB_FRAMING", "patch")  # typo
        with pytest.raises(ValueError, match="FFTLAB_FRAMING"):
            frame_signal_strided(np.zeros(64, np.float32), 16, 8, 7)


class TestWisdom:
    def test_record_lookup_roundtrip(self, tmp_path):
        from fftlab.plan import wisdom

        wisdom.record(12345, "f32", "stockham_mxu", 0.42)
        got = wisdom.lookup(12345, "f32")
        assert got is not None and got["algorithm"] == "stockham_mxu"
        p = str(tmp_path / "wisdom.json")
        wisdom.export_wisdom(p)
        wisdom.forget()
        assert wisdom.lookup(12345, "f32") is None
        wisdom.import_wisdom(p)
        assert wisdom.lookup(12345, "f32")["algorithm"] == "stockham_mxu"

    def test_import_no_overwrite_keeps_fresh_entries(self, tmp_path):
        # The lazy auto-load (split_tuning._ensure_wisdom_loaded) must
        # not clobber measurements taken THIS process.
        from fftlab.plan import wisdom

        wisdom.forget()
        wisdom.record(777, "f32", "old_algo", 9.9)
        p = str(tmp_path / "wisdom.json")
        wisdom.export_wisdom(p)
        wisdom.forget()
        wisdom.record(777, "f32", "fresh_algo", 0.1)
        wisdom.record(888, "f32", "only_in_memory", 0.2)
        n = wisdom.import_wisdom(p, overwrite=False)
        assert n == 1
        assert wisdom.lookup(777, "f32")["algorithm"] == "fresh_algo"
        assert wisdom.lookup(888, "f32")["algorithm"] == "only_in_memory"
        wisdom.forget()

    def test_wisdom_file_tier(self, tmp_path, monkeypatch):
        # The user wisdom file is auto-loaded by the first leaf lookup of
        # a fresh process, and must NOT outrank session entries.
        import json

        from fftlab.plan import split_tuning, wisdom

        user = tmp_path / "user_wisdom.json"
        user.write_text(json.dumps({
            "split:1048576:f32": {"algorithm": "leaf=256", "time_ms": 1.0,
                                  "platform": "cpu"},
            "split:4096:f32": {"algorithm": "leaf=512", "time_ms": 0.1,
                               "platform": "cpu"},
        }))
        monkeypatch.delenv("FFTLAB_NO_WISDOM_FILE", raising=False)
        monkeypatch.setenv("FFTLAB_WISDOM_PATH", str(user))
        monkeypatch.setattr(split_tuning, "_WISDOM_FILE_LOADED", False)
        wisdom.forget()
        # Session measurement for 4096 outranks the file entry.
        wisdom.record(4096, "f32", "leaf=64", 0.05, kind="split",
                      extra={"platform": "cpu"})
        assert split_tuning.best_leaf(1 << 20) == 256
        assert split_tuning.best_leaf(4096) == 64
        wisdom.forget()
        monkeypatch.setattr(split_tuning, "_WISDOM_FILE_LOADED", False)


class TestBenchHarness:
    def test_benchmark_algorithm_result(self):
        from fftlab.bench.harness import benchmark_algorithm

        r = benchmark_algorithm("radix2_dit", 64, batch=2, iters=2)
        assert r.roundtrip_ok and r.max_error < 1e-3
        assert r.ms > 0 and r.gsamples_per_s > 0

    def test_unsupported_size_raises(self):
        from fftlab.bench.harness import benchmark_algorithm

        with pytest.raises(ValueError):
            benchmark_algorithm("radix2_dit", 100)

    def test_roofline_accounting(self):
        from fftlab.bench.harness import roofline

        r = roofline(1 << 20, 16, 5e-3, peak_flops=67e12, hbm_gbps=3350.0)
        assert r["bound"] in ("bandwidth", "compute")
        assert r["effective_gflops"] > 0
        with pytest.raises(TypeError):  # no device's peaks are assumed
            roofline(1 << 20, 16, 5e-3)

    def test_complexity_exponent_nlogn(self):
        from fftlab.bench.harness import BenchResult, complexity_exponent

        rs = [BenchResult("x", n, 1, n * np.log2(n) * 1e-6, 0, 0, 0, 0, True)
              for n in (1024, 4096, 16384, 65536)]
        e = complexity_exponent(rs)
        assert 1.0 < e < 1.3  # ~n log n


class TestViz:
    """Pedagogical visualizers (radix2_dit.c:147-173,
    iterative_fft.c:101-175 analogs)."""

    def test_butterfly_diagram_structure(self):
        from fftlab.utils.viz import butterfly_diagram

        d = butterfly_diagram(8)
        # 3 stages for n=8; all 8 outputs present; bitrev input order
        assert "stage 3" in d and "stage 4" not in d
        for k in range(8):
            assert f"X[{k}]" in d
        first_col = [ln.split()[0] for ln in d.splitlines()[1:9]]
        assert first_col == [f"x[{v}]" for v in [0, 4, 2, 6, 1, 5, 3, 7]]

    def test_butterfly_diagram_rejects(self):
        from fftlab.utils.viz import butterfly_diagram

        with pytest.raises(ValueError):
            butterfly_diagram(12)
        with pytest.raises(ValueError):
            butterfly_diagram(64)

    def test_memory_access_trace(self):
        from fftlab.utils.viz import memory_access_trace

        t = memory_access_trace(1 << 14)
        assert "pair stride" in t
        assert t.count("\n") >= 14  # one row per stage + headers

    def test_tile_touch_model(self):
        from fftlab.utils.viz import simulate_tile_touches

        r = simulate_tile_touches(1 << 20)
        assert r["tiles"] == (1 << 20) // 1024
        assert r["dit_tile_touches"] >= r["stockham_tile_touches"]
        assert r["ratio"] >= 1.0


class TestOpenMPParity:
    """fft_openmp.c:18-53 mapping (docs/parity.md): the three OpenMP
    parallel-for loops become whole-array ops; numerics match the
    reference's N=8 radix-2 semantics exactly."""

    def test_n8_matches_oracle_float64(self):
        import jax.numpy as jnp
        from fftlab.algos.radix2 import radix2_dit

        rng = np.random.default_rng(8)
        x = rng.standard_normal(8) + 1j * rng.standard_normal(8)
        got = np.asarray(radix2_dit(jnp.asarray(x, jnp.complex128)))
        np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-12)

    def test_stage_is_single_array_op(self):
        # the "loop parallelism" claim: one whole-array op per stage —
        # no python-level loop over butterflies in the jaxpr (the HLO
        # has O(log n) ops, not O(n)).
        import jax
        import jax.numpy as jnp
        from fftlab.algos.stockham import stockham_fft

        n = 1 << 10
        jaxpr = jax.make_jaxpr(stockham_fft)(jnp.zeros(n, jnp.complex64))
        assert len(jaxpr.jaxpr.eqns) < 64  # O(log n), not O(n)


class TestMeasureProtocol:
    """FFT_MEASURE: the slope protocol + sane rankings."""

    def test_wisdom_entry_carries_protocol(self):
        import jax.numpy as jnp
        from fftlab.plan import wisdom
        from fftlab.plan.flags import Flags, PlanConfig
        from fftlab.plan.planner import measure_algorithm
        from fftlab.core.types import FORWARD

        wisdom.forget()
        name = measure_algorithm(256, FORWARD, jnp.complex64,
                                 Flags.MEASURE, PlanConfig(),
                                 batch=2, iters=3)
        entry = wisdom.lookup(256, "f32")
        assert entry is not None and entry["algorithm"] == name
        assert entry["protocol"] == "slope"
        wisdom.forget()

    def test_measured_ranks_naive_dft_slowest(self):
        # EXHAUSTIVE includes the O(n^2) oracle; at n=1024 (where the
        # n^2/n*log(n) gap is ~100x) a correct timing protocol must
        # never crown it the winner, even on a loaded CI machine.
        import jax.numpy as jnp
        from fftlab.plan import wisdom
        from fftlab.plan.flags import Flags, PlanConfig
        from fftlab.plan.planner import measure_algorithm
        from fftlab.core.types import FORWARD

        wisdom.forget()
        name = measure_algorithm(1024, FORWARD, jnp.complex64,
                                 Flags.EXHAUSTIVE, PlanConfig(),
                                 batch=4, iters=3)
        assert name not in ("naive_dft", "optimized_dft")
        wisdom.forget()

    def test_slope_time_monotone_in_work(self):
        import jax
        import jax.numpy as jnp
        from fftlab.bench.timing import slope_time

        big = jnp.ones((256, 2048), jnp.float32)
        small = jnp.ones((8, 64), jnp.float32)

        @jax.jit
        def heavy(a):
            for _ in range(30):
                a = jnp.sin(a) * 1.0001
            return a

        # fresh input per unbounded index (the slope_time contract)
        t_small = slope_time(heavy, lambda i: (small + i,), iters=4)
        t_big = slope_time(heavy, lambda i: (big + i,), iters=4)
        assert t_big > t_small
