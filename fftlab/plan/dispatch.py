"""Capability-driven routing for the split-plane device path.

The reference dispatches through a backend vtable selected at runtime
(fft_gpu.c:49-97). Here the equivalent choice is one function,
`select_split_impl`, and one executor keyed by route name, `run_route`,
shared by `fft_split_auto`, the split plans (plan.api) and leaf tuning
(plan.split_tuning) so that tuning measures exactly what dispatch runs.

Routes (split re/im planes, [..., n] batch-first):

  einsum   the XLA split-Stockham path (algos/split_stockham.py): one
           real contraction per stage at Precision.HIGHEST, with the
           contraction leaf taken from measured leaf wisdom when present
"""

from __future__ import annotations

ROUTES = ("einsum",)


def select_split_impl(n: int, batch: int = 1) -> str:
    """Route for an n-point split-plane FFT with `batch` rows."""
    return "einsum"


def spectral_filter_auto(xr, xi, hr, hi, permuted=None):
    """The FFT -> H -> IFFT sandwich (fft_filtering.c:111-132 hot path)
    — ONE dispatcher shared by dsp.filtering, dsp.convolution, and the
    Bluestein convolution so the route policy lives in one place.

    xr, xi: [..., n] split planes; hr, hi: the length-n frequency
    response in NATURAL bin order (host numpy or device array; the
    fused route digit-reverses a host constant at plan time itself).
    `permuted` optionally supplies a pre-permuted (hr_p, hi_p) pair —
    pass it when H is a cached plan-time constant so the O(n) host
    gather isn't redone per call.
    Numerics: ifft(fft(x) * H), 1/n scaled."""
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import spectral_filter_split_fused

    if permuted is not None:
        hr_p, hi_p = permuted
        return spectral_filter_split_fused(xr, xi, jnp.asarray(hr_p),
                                           jnp.asarray(hi_p),
                                           h_permuted=True)
    return spectral_filter_split_fused(xr, xi, hr, hi)


def fft_split_auto(xr, xi, direction=None):
    """Split-plane FFT through the capability-selected route."""
    from fftlab.core.types import FORWARD

    if direction is None:
        direction = FORWARD
    import jax.numpy as jnp

    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    n = int(xr.shape[-1])
    batch = 1
    for d in xr.shape[:-1]:
        batch *= int(d)
    route = select_split_impl(n, batch)
    return run_route(route, xr, xi, direction)


def run_route(route: str, xr, xi, direction, scale: float | None = None):
    """Execute a split-plane FFT through a NAMED route (the vtable row
    of fft_gpu.c:140-287, keyed by route name instead of backend enum).

    `scale` folds an output normalization into the route; on the XLA
    route the multiply fuses into the last contraction."""
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import fft_split
    from fftlab.plan.split_tuning import best_leaf

    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; want one of {ROUTES}")
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    # Consume leaf wisdom (tune_split_leaf): the measured contraction
    # leaf for this size, defaulting to DEFAULT_LEAF_SPLIT when never
    # tuned — so the route actually executes what was measured.
    yr, yi = fft_split(xr, xi, direction, best_leaf(int(xr.shape[-1])))
    if scale is None:
        return yr, yi
    s = jnp.asarray(scale, dtype=yr.dtype)
    return yr * s, yi * s
