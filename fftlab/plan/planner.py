"""Algorithm selection and plan autotuning.

The analog of the reference's size-class heuristic
(fft_auto.c:136-172) plus a REAL implementation of FFT_MEASURE
(the reference's is a TODO stub, fft_auto.c:233-235).

Reference heuristic (for parity documentation): pow2 n<=64 -> radix2-DIT,
n<=1024 -> radix4-if-divisible, else split-radix; prime -> Bluestein;
highly-composite -> mixed-radix. This heuristic is simpler because the
hardware changed the trade-offs: the matmul Stockham path dominates every
size it supports (all prime factors <= leaf), and Bluestein covers the
rest — but MEASURE mode times the real candidates on the real device, so
the heuristic is only the ESTIMATE-mode default.
"""

from __future__ import annotations

import functools

from fftlab.algos.mixed_radix import is_highly_composite, is_prime
from fftlab.algos.stockham import max_prime_factor
from fftlab.core.types import is_power_of, is_power_of_two
from fftlab.plan import wisdom
from fftlab.plan.flags import Flags, PlanConfig


def estimate_algorithm(n: int, config: PlanConfig) -> str:
    """ESTIMATE-mode selection (no measurement)."""
    if config.algorithm is not None:
        return config.algorithm
    if n <= 2:
        return "naive_dft"
    if max_prime_factor(n) <= config.leaf:
        return "stockham_mxu"
    return "bluestein"


def reference_heuristic(n: int) -> str:
    """The reference's own selection logic (fft_auto.c:136-172), exposed for
    parity tests and documentation — NOT used as the default."""
    if is_power_of_two(n):
        if n <= 64:
            return "radix2_dit"
        if n <= 1024:
            return "radix4" if is_power_of(n, 4) else "radix2_dit"
        return "split_radix"
    if is_prime(n):
        return "bluestein"
    if is_highly_composite(n):
        return "mixed_radix"
    return "bluestein"


def candidate_algorithms(n: int, flags: Flags, config: PlanConfig) -> list[str]:
    """Candidate set for MEASURE/PATIENT/EXHAUSTIVE autotuning."""
    from fftlab.algos import build_registry

    reg = build_registry()
    cands = [name for name, spec in reg.items() if spec.supports(n)]
    # Order: flagship first so ties break toward it; drop the O(n^2) oracle
    # and pedagogy entries unless EXHAUSTIVE.
    if not flags & Flags.EXHAUSTIVE:
        drop = {"naive_dft", "optimized_dft", "recursive", "iterative"}
        cands = [c for c in cands if c not in drop]
    order = {"stockham_mxu": 0, "radix4": 1, "split_radix": 2, "radix2_dit": 3}
    cands.sort(key=lambda c: order.get(c, 10))
    return cands


def measure_algorithm(n: int, direction, dtype, flags: Flags, config: PlanConfig,
                      batch: int = 8, iters: int = 5) -> str:
    """Time each candidate on the device; record and return the winner.

    Timing uses the slope protocol (fftlab.bench.timing): inputs vary
    per iteration, completion is fenced with block_until_ready, and the
    per-iteration cost is a two-point slope that cancels dispatch
    latency. Wisdom entries carry ``protocol: "slope"``. The reference
    left MEASURE a TODO (fft_auto.c:233-235)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fftlab.algos import build_registry
    from fftlab.bench.timing import PROTOCOL, slope_time

    reg = build_registry()
    precision = "f64" if np.dtype(dtype) == np.complex128 else "f32"
    cached = wisdom.lookup(n, precision)
    if cached is not None and cached["algorithm"] in reg:
        return cached["algorithm"]
    if flags & Flags.WISDOM_ONLY:
        raise RuntimeError(f"WISDOM_ONLY set but no wisdom for n={n} ({precision})")

    k1, k2 = jax.random.split(jax.random.key(0))
    re = jax.random.normal(k1, (batch, n))
    im = jax.random.normal(k2, (batch, n))
    x = jnp.asarray(re + 1j * im, dtype=dtype)
    best_name, best_t = None, float("inf")
    for name in candidate_algorithms(n, flags, config):
        fn = jax.jit(functools.partial(reg[name].fn, direction=direction))
        try:
            dt = slope_time(
                fn, lambda i: (x * (1.0 + 1e-3 * i),), iters=iters
            ) * 1e3
        except Exception:
            continue
        if dt < best_t:
            best_name, best_t = name, dt
    if best_name is None:
        return estimate_algorithm(n, config)
    wisdom.record(n, precision, best_name, best_t,
                  extra={"protocol": PROTOCOL})
    return best_name


def select_algorithm(n: int, direction, dtype, config: PlanConfig) -> str:
    flags = config.flags
    if config.algorithm is not None:
        return config.algorithm
    import numpy as np

    precision = "f64" if np.dtype(dtype) == np.complex128 else "f32"
    cached = wisdom.lookup(n, precision)
    if cached is not None:
        # Validate against the live registry (measure_algorithm does):
        # a stale/hand-edited wisdom file naming a renamed algorithm
        # must fall through to ESTIMATE, not KeyError at plan build.
        from fftlab.algos import build_registry

        algo = cached.get("algorithm")
        if algo in build_registry():
            return algo
    if flags & (Flags.MEASURE | Flags.PATIENT | Flags.EXHAUSTIVE | Flags.WISDOM_ONLY):
        return measure_algorithm(n, direction, dtype, flags, config)
    return estimate_algorithm(n, config)
