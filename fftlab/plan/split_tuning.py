"""On-device autotuning for the split-plane path (FFT_MEASURE for the
device pipeline — the reference left MEASURE a TODO, fft_auto.c:233-235;
plan/planner.py implements it for the complex registry; this module
covers the split path's real knob: the stage leaf radix).

Winners persist through plan/wisdom.py under kind='split', tagged with
the platform they were measured on, and are written to the wisdom file
so later processes skip the measurement.
"""

from __future__ import annotations

import numpy as np

from fftlab.plan import wisdom

DEFAULT_LEAVES = (64, 128, 256, 512)


def _measure_leaf(n: int, leaf: int, batch: int, iters: int) -> float:
    import jax
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import fft_split
    from fftlab.bench.timing import slope_time

    rng = np.random.default_rng(0)
    xr = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    xi = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    f = jax.jit(lambda a, b: fft_split(a, b, leaf=leaf))
    return slope_time(f, lambda i: (xr + i * 1e-3, xi), iters=iters)


def tune_split_leaf(n: int, leaves=DEFAULT_LEAVES, batch: int = 4,
                    iters: int = 6, persist: bool = True) -> int:
    """Measure each candidate leaf for an n-point split FFT on the
    current device; record and return the winner.

    persist=True records the winner in the in-process table AND merges
    it into the wisdom file (never clobbering other sizes' entries)."""
    import jax

    from fftlab.algos.stockham import max_prime_factor

    best_leaf, best_t = None, float("inf")
    for leaf in leaves:
        if max_prime_factor(n) > leaf:
            continue
        try:
            dt = _measure_leaf(n, leaf, batch, iters)
        except Exception:
            continue
        if dt < best_t:
            best_leaf, best_t = leaf, dt
    if best_leaf is None:
        from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT

        return DEFAULT_LEAF_SPLIT
    if persist:
        from fftlab.bench.timing import PROTOCOL

        wisdom.record(n, "f32", f"leaf={best_leaf}", best_t * 1e3,
                      kind="split",
                      extra={"protocol": PROTOCOL, "batch": batch,
                             "platform": jax.default_backend()})
        try:
            wisdom.import_wisdom(overwrite=False)
            wisdom.export_wisdom()
        except OSError:  # an unwritable cache dir must not fail tuning
            pass
    return best_leaf


_WISDOM_FILE_LOADED = False


def _ensure_wisdom_loaded() -> None:
    """Lazy one-time import of the default wisdom file, so leaves
    measured by an earlier process serve later ones — FFTW auto-loads
    system wisdom the same way. Opt out with FFTLAB_NO_WISDOM_FILE=1.
    In-process entries always win (overwrite=False keeps them)."""
    global _WISDOM_FILE_LOADED
    if _WISDOM_FILE_LOADED:
        return
    _WISDOM_FILE_LOADED = True
    import os

    if os.environ.get("FFTLAB_NO_WISDOM_FILE"):
        return
    try:
        wisdom.import_wisdom(overwrite=False)
    except (OSError, ValueError):  # malformed file must never break dispatch
        pass


def best_leaf(n: int) -> int:
    """Wisdom-recorded leaf for n, or the default. An entry measured on
    a different platform (wisdom files travel via export/import) is
    ignored."""
    import jax

    from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT

    _ensure_wisdom_loaded()
    cached = wisdom.lookup(n, "f32", kind="split")
    if not cached or not cached["algorithm"].startswith("leaf="):
        return DEFAULT_LEAF_SPLIT
    platform = cached.get("platform")
    if platform is not None and platform != jax.default_backend():
        return DEFAULT_LEAF_SPLIT
    return int(cached["algorithm"].split("=", 1)[1])
