"""Headline benchmark suite: one JSON line on stdout.

Each row runs one public entry point at the size its users call it with
(a toy size when the platform is the CPU), gates it on its SNR against a
float64 NumPy reference, and times it with
`fftlab.bench.harness.time_fn` (pipelined calls, one
`block_until_ready` per repeat, median over repeats):

  fft_1m_batched      16 x 2^20 split c2c (fft_split_auto)
  fft_16m_single      one 2^24 split c2c
  spectral_filter_1m  16 x 2^20 FFT -> H -> IFFT (spectral_filter_auto)
  serving_filter      FilterPlan, 129 taps over 2^23 samples, two planes
  bluestein_prime     n = 500009 (prime), batch 4
  rfft_2m             8 x 2^21 r2c (plan_r2c_1d_split)
  stft                stft_split 2048/512 over 2^22 samples

The line names the device (platform, kind, count) and the card's power
limit as nvidia-smi reports it. The headline value is the batched
1M-point throughput. Exit status is 1 if any row failed its gate.

Run: python bench.py
"""

from __future__ import annotations

import json
import sys

import numpy as np

SNR_GATE_DB = 100.0  # float32 at Precision.HIGHEST; TF32 lands near 60


def _snr_db(got, want) -> float:
    got = np.asarray(got, np.complex128)
    err = np.sum(np.abs(got - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def _row(fn, args, got, want, samples: int, gate: float = SNR_GATE_DB,
         repeats: int = 5) -> dict:
    from fftlab.bench.harness import time_fn

    snr = _snr_db(got, want)
    if snr < gate:
        return {"error": f"accuracy gate failed: {snr:.1f} dB < {gate}",
                "snr_db": snr}
    sec = time_fn(fn, args, iters=4, repeats=repeats)
    return {"ms": sec * 1e3, "gsps": samples / sec / 1e9, "snr_db": snr}


def _split_pair(rng, shape):
    import jax.numpy as jnp

    return (jnp.asarray(rng.standard_normal(shape), jnp.float32),
            jnp.asarray(rng.standard_normal(shape), jnp.float32))


def _as_c128(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def bench_fft(n: int, batch: int, seed: int) -> dict:
    import jax

    from fftlab.plan.dispatch import fft_split_auto

    xr, xi = _split_pair(np.random.default_rng(seed), (batch, n))
    fn = jax.jit(fft_split_auto)
    yr, yi = fn(xr, xi)
    want = np.fft.fft(_as_c128(xr[0], xi[0]))
    return _row(fn, (xr, xi), _as_c128(yr[0], yi[0]), want, batch * n)


def bench_spectral_filter(n: int, batch: int) -> dict:
    import jax

    from fftlab.algos.split_stockham import permute_response
    from fftlab.plan.dispatch import spectral_filter_auto

    rng = np.random.default_rng(4)
    xr, xi = _split_pair(rng, (batch, n))
    H = rng.standard_normal(n).astype(np.float32)
    hz = np.zeros(n, np.float32)
    perm = permute_response(H, hz, n)
    fn = jax.jit(lambda a, b: spectral_filter_auto(a, b, H, hz,
                                                   permuted=perm))
    yr, yi = fn(xr, xi)
    want = np.fft.ifft(np.fft.fft(_as_c128(xr[0], xi[0])) * H)
    return _row(fn, (xr, xi), _as_c128(yr[0], yi[0]), want, batch * n)


def bench_serving_filter(n: int) -> dict:
    from fftlab.plan.filter_plan import FilterPlan

    rng = np.random.default_rng(2)
    h = (rng.standard_normal(129) / 129).astype(np.float32)
    xr, xi = _split_pair(rng, (n,))
    plan = FilterPlan(h)
    fn = lambda a, b: plan(a, b)  # noqa: E731
    yr, yi = fn(xr, xi)
    m = min(n, 1 << 17)  # y[:m] depends only on x[:m]
    want = np.convolve(_as_c128(xr[:m], xi[:m]), h.astype(np.float64))[:m]
    return _row(fn, (xr, xi), _as_c128(yr[:m], yi[:m]), want, 2 * n)


def bench_bluestein(n: int, batch: int) -> dict:
    r = bench_fft(n, batch, seed=6)
    r["n"] = n
    return r


def bench_rfft(n: int, batch: int) -> dict:
    import jax
    import jax.numpy as jnp

    from fftlab.plan.api import plan_r2c_1d_split

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    plan = plan_r2c_1d_split(n)
    fn = jax.jit(plan.fn)
    Xr, Xi = fn(x)
    want = np.fft.rfft(np.asarray(x[0], np.float64))
    r = _row(fn, (x,), _as_c128(Xr[0], Xi[0]), want, batch * n)
    r["path"] = plan.algorithm
    return r


def bench_stft(n: int, frame: int = 2048, hop: int = 512) -> dict:
    import jax
    import jax.numpy as jnp

    from fftlab.core.framing import frames_needed
    from fftlab.core.window import get_window
    from fftlab.dsp.stft import stft_split

    x = jnp.asarray(np.random.default_rng(3).standard_normal(n), jnp.float32)
    fn = jax.jit(lambda s: stft_split(s, frame, hop))
    Sr, Si = fn(x)
    w = np.asarray(get_window("hann", frame), np.float64)
    k = min(frames_needed(n, frame, hop), 64)
    xs = np.asarray(x, np.float64)
    frames = np.stack([xs[i * hop: i * hop + frame] for i in range(k)])
    want = np.fft.rfft(frames * w, axis=-1)
    return _row(fn, (x,), _as_c128(Sr[:k], Si[:k]), want, n)


def main() -> int:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from fftlab.plan.hardware import gpu_name_and_power_limit

    d0 = jax.devices()[0]
    real = d0.platform != "cpu"
    rows = {
        "fft_1m_batched": lambda: bench_fft(
            1 << 20 if real else 1 << 12, 16 if real else 2, seed=0),
        "fft_16m_single": lambda: bench_fft(
            1 << 24 if real else 1 << 14, 1, seed=1),
        "spectral_filter_1m": lambda: bench_spectral_filter(
            1 << 20 if real else 1 << 12, 16 if real else 2),
        "serving_filter": lambda: bench_serving_filter(
            1 << 23 if real else 1 << 14),
        "bluestein_prime": lambda: bench_bluestein(
            500009 if real else 10007, 4 if real else 1),
        "rfft_2m": lambda: bench_rfft(
            1 << 21 if real else 1 << 12, 8 if real else 2),
        "stft": lambda: bench_stft(1 << 22 if real else 1 << 14),
    }
    detail = {}
    for name, run in rows.items():
        try:
            detail[name] = run()
        except Exception as e:  # a failed row is reported, not fatal
            detail[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    head = detail["fft_1m_batched"]
    line = {
        "metric": "fft_1m_batched_throughput",
        "value": head.get("gsps", 0.0),
        "unit": "Gsamples/s",
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu_name_and_power_limit(),
        "detail": detail,
    }
    print(json.dumps(line, separators=(",", ":")), flush=True)
    return 1 if any("error" in r for r in detail.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
