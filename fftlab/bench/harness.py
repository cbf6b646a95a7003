"""Benchmark harness with accuracy gates and roofline accounting.

The analog of benchmarks/benchmark_all.c: warm-up run then timed
iterations (:119-131, here with async dispatch + one block_until_ready
per repeat), max/RMS error vs a reference transform (:79-91), round-trip
reconstruction gate (:152-157), size-scaled iteration counts (:274-279),
and empirical complexity-exponent estimation (:240-266) — plus what the
reference lacks: roofline accounting (achieved fraction of the
5*n*log2(n) FLOP model and of memory bandwidth, against peaks the caller
supplies for its device).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class BenchResult:
    algorithm: str
    n: int
    batch: int
    ms: float
    gsamples_per_s: float
    gflops_effective: float  # 5*n*log2(n) model
    max_error: float
    rms_error: float
    roundtrip_ok: bool


def _iters_for(n: int) -> int:
    """Size-scaled iteration counts (benchmark_all.c:274-279)."""
    for limit, iters in [(64, 200), (1024, 100), (16384, 50), (262144, 20)]:
        if n <= limit:
            return iters
    return 10


def time_fn(fn, args, iters: int, repeats: int = 3) -> float:
    """Median seconds/iteration; pipelined dispatch, one
    block_until_ready per repeat. Inputs are perturbed per iteration so
    that no call can reuse another's result."""
    import jax
    import jax.numpy as jnp

    def perturb(a, i):
        if isinstance(a, jnp.ndarray) and jnp.issubdtype(a.dtype, jnp.inexact):
            return a + jnp.asarray(i, dtype=jnp.result_type(a.real)).astype(a.dtype)
        return a

    jax.block_until_ready(fn(*tuple(perturb(a, -1) for a in args)))  # warm
    times = []
    for r in range(repeats):
        argsets = [tuple(perturb(a, r * iters + i) for a in args)
                   for i in range(iters)]
        jax.block_until_ready(argsets)
        t0 = time.perf_counter()
        outs = [fn(*a) for a in argsets]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def benchmark_algorithm(name: str, n: int, batch: int = 1,
                        dtype=np.complex64, iters: int | None = None) -> BenchResult:
    """Time one registry algorithm at one size, with accuracy gates."""
    import functools

    import jax
    import jax.numpy as jnp

    from fftlab.algos import build_registry
    from fftlab.core.types import Direction

    spec = build_registry()[name]
    if not spec.supports(n):
        raise ValueError(f"{name} does not support n={n}")
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    x = jnp.asarray(xh.astype(dtype))
    fwd = jax.jit(functools.partial(spec.fn, direction=Direction.FORWARD))
    inv = jax.jit(functools.partial(spec.fn, direction=Direction.INVERSE))

    want = np.fft.fft(xh)
    got = np.asarray(fwd(x), dtype=np.complex128)
    err = np.abs(got - want)
    ref_scale = max(float(np.max(np.abs(want))), 1e-300)
    back = np.asarray(inv(fwd(x)), dtype=np.complex128)
    rt_tol = 1e-10 if np.dtype(dtype) == np.complex128 else 1e-4
    roundtrip_ok = bool(np.max(np.abs(back - xh)) < rt_tol * max(1.0, ref_scale))

    it = iters if iters is not None else _iters_for(n)
    sec = time_fn(fwd, (x,), it)
    total = batch * n
    return BenchResult(
        algorithm=name, n=n, batch=batch, ms=sec * 1e3,
        gsamples_per_s=total / sec / 1e9,
        gflops_effective=5.0 * total * np.log2(max(n, 2)) / sec / 1e9,
        max_error=float(err.max()), rms_error=float(np.sqrt((err**2).mean())),
        roundtrip_ok=roundtrip_ok,
    )


def benchmark_suite(sizes=(16, 64, 256, 1024, 4096, 16384),
                    algorithms=None, batch: int = 1,
                    dtype=np.complex64) -> list[BenchResult]:
    """The cross-algorithm sweep (benchmark_all.c main loop)."""
    from fftlab.algos import build_registry

    reg = build_registry()
    if algorithms is None:
        algorithms = [a for a in reg if a not in ("naive_dft", "optimized_dft")]
    out = []
    for n in sizes:
        for name in algorithms:
            if reg[name].supports(n):
                out.append(benchmark_algorithm(name, n, batch, dtype))
    return out


def complexity_exponent(results: list[BenchResult]) -> float:
    """Empirical exponent from time ratios (benchmark_all.c:240-266):
    slope of log(t) vs log(n) over a same-algorithm size sweep."""
    pts = [(r.n, r.ms) for r in results]
    if len(pts) < 2:
        return float("nan")
    ln = np.log([p[0] for p in pts])
    lt = np.log([max(p[1], 1e-9) for p in pts])
    return float(np.polyfit(ln, lt, 1)[0])


def roofline(n: int, batch: int, sec: float, *, peak_flops: float,
             hbm_gbps: float, dtype_bytes: int = 8,
             passes: float = 3.0) -> dict:
    """Achieved fraction of compute and bandwidth rooflines.

    `peak_flops` and `hbm_gbps` are the device's peaks, which the caller
    supplies (no device is assumed); `passes` = memory round trips of
    the array the algorithm makes.
    """
    total = batch * n
    eff_flops = 5.0 * total * np.log2(max(n, 2)) / sec
    bytes_moved = passes * 2 * total * dtype_bytes  # read+write per pass
    achieved_bw = bytes_moved / sec / 1e9
    return {
        "effective_gflops": eff_flops / 1e9,
        "flops_fraction": eff_flops / peak_flops,
        "achieved_gbps": achieved_bw,
        "bandwidth_fraction": achieved_bw / hbm_gbps,
        "bound": "bandwidth" if achieved_bw / hbm_gbps > eff_flops / peak_flops
                 else "compute",
    }


def print_table(results: list[BenchResult]) -> str:
    """The per-size best-implementation table (benchmark_all.c:189-237)."""
    lines = [f"{'algorithm':<16}{'n':>9}{'ms':>12}{'GS/s':>9}"
             f"{'eff GFLOP/s':>13}{'max err':>11}{'rt':>4}"]
    for r in results:
        lines.append(
            f"{r.algorithm:<16}{r.n:>9}{r.ms:>12.4f}{r.gsamples_per_s:>9.3f}"
            f"{r.gflops_effective:>13.2f}{r.max_error:>11.2e}"
            f"{'ok' if r.roundtrip_ok else 'FAIL':>4}"
        )
    best: dict[int, BenchResult] = {}
    for r in results:
        if r.n not in best or r.ms < best[r.n].ms:
            best[r.n] = r
    lines.append("\nbest per size:")
    for n in sorted(best):
        lines.append(f"  n={n:<8} {best[n].algorithm} ({best[n].ms:.4f} ms)")
    return "\n".join(lines)
