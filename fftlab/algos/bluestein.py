"""Bluestein / chirp-z FFT for arbitrary transform sizes.

The analog of reference algorithms/core/bluestein.c:79-148, with the
key planning improvement SURVEY.md §3.3 calls out: the chirp sequence AND
the FFT of the convolution kernel are plan-time constants (computed host-
side in float64, cached per (n, direction)), so each execution costs only
ONE forward + ONE inverse power-of-two FFT plus O(n) modulations — the
reference recomputes the kernel FFT every call (bluestein.c:125).

Identity: with c[k] = exp(i*pi*dir*k^2/n),
    X[k] = c[k] * sum_j (x[j]*c[j]) * conj(c[k-j])
which is a linear convolution of a[j] = x[j]*c[j] with conj(c), evaluated
circularly at size m = next_pow2(2n-1) (bluestein.c:87).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.algos.radix2 import radix2_dit_unscaled
from fftlab.core.hostfft import bluestein_kernel_spectrum_np
from fftlab.core.twiddle import chirp_np
from fftlab.core.types import Direction, FORWARD, next_power_of_two


def bluestein_fft(x, direction=FORWARD, pow2_fft=None):
    """Arbitrary-n FFT via chirp-z. `pow2_fft(x, direction)` is the internal
    unscaled power-of-two transform (default: the radix-2 kernel; the planner
    substitutes the matmul Stockham path for large m)."""
    x, n, direction = prepare(x, direction)
    if n == 1:
        return x
    if pow2_fft is None:
        pow2_fft = radix2_dit_unscaled

    m = next_power_of_two(2 * n - 1)
    c = chirp_np(n, direction)  # c[k] = exp(i*pi*dir*k^2/n), float64 host table
    B = bluestein_kernel_spectrum_np(n, m, int(direction))  # FFT_m(kernel), const

    # Modulate and zero-pad: a[j] = x[j]*c[j] (bluestein.c:107-109).
    a = x * const(c, x)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    a = jnp.pad(a, pad)

    # Circular convolution with the chirp kernel via the pow-2 transform
    # (bluestein.c:123-133); kernel spectrum is a baked constant.
    A = pow2_fft(a, Direction.FORWARD)
    conv = pow2_fft(A * const(B, x), Direction.INVERSE)
    # Internal inverse must be scaled by 1/m; pow2_fft is unscaled.
    conv = conv * jnp.asarray(1.0 / m, dtype=jnp.real(x).dtype)

    # Demodulate (bluestein.c:139-141) and apply the API's inverse 1/n.
    y = conv[..., :n] * const(c, x)
    return inverse_scale(y, n, direction)


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("bluestein_fft", bluestein_fft)


@functools.lru_cache(maxsize=64)
def _kernel_planes_np(n: int, m: int, direction: int, dtype_str: str):
    """Plan-time constants for the Bluestein convolution kernel: the
    spectrum B in natural order AND its digit-reversed copy (the form
    the fused einsum sandwich consumes) — cached per (n, direction,
    dtype) so the O(m) host gather is a one-time plan cost, matching
    the module header's 'plan-time constants' contract."""
    from fftlab.algos.split_stockham import permute_response

    rdtype = np.dtype(dtype_str)
    B = bluestein_kernel_spectrum_np(n, m, direction)
    Br = B.real.astype(rdtype)
    Bi = B.imag.astype(rdtype)
    Br_p, Bi_p = permute_response(Br, Bi, m)
    return Br, Bi, Br_p, Bi_p


def _conv_sandwich_split(ar, ai, Br, Bi, m: int, permuted=None):
    """The Bluestein circular convolution IFFT_m(FFT_m(a) * B), 1/m
    scaled — which is exactly the spectral-filter sandwich, routed by
    the shared dispatcher (plan.dispatch.spectral_filter_auto): the
    zero-transpose fused einsum sandwich. B's bin order only matters
    inside the multiply, so the digit-reversed form applies unchanged."""
    from fftlab.plan.dispatch import spectral_filter_auto

    return spectral_filter_auto(ar, ai, Br, Bi, permuted=permuted)


def bluestein_fft_split(xr, xi, direction=FORWARD):
    """Arbitrary-n chirp-z FFT on split re/im planes — no complex dtype
    anywhere.

    Same plan-time constants as `bluestein_fft` (chirp + kernel spectrum
    in float64), with the internal power-of-two convolution routed
    through the fused spectral-filter sandwich (`_conv_sandwich_split`).
    Forward unscaled / inverse 1/n.
    """
    from fftlab.algos.split_stockham import _twiddle_split

    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    if n == 1:
        return xr, xi
    rdtype = np.dtype(xr.dtype)

    m = next_power_of_two(2 * n - 1)
    c = chirp_np(n, direction)
    cr = jnp.asarray(c.real.astype(rdtype))
    ci = jnp.asarray(c.imag.astype(rdtype))
    # B stays host-side, cached with its digit-reversed copy (the form
    # the einsum sandwich route consumes) per (n, direction, dtype).
    Br, Bi, Br_p, Bi_p = _kernel_planes_np(n, m, int(direction), rdtype.str)

    ar, ai = _twiddle_split(xr, xi, cr, ci)  # a = x * c
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)

    # Circular convolution with the chirp kernel = the FFT -> B -> IFFT
    # sandwich at size m (1/m scaling included by every route).
    vr, vi = _conv_sandwich_split(ar, ai, Br, Bi, m,
                                  permuted=(Br_p, Bi_p))

    yr, yi = _twiddle_split(vr[..., :n], vi[..., :n], cr, ci)
    if direction == Direction.INVERSE:
        sn = jnp.asarray(1.0 / n, dtype=rdtype)
        return yr * sn, yi * sn
    return yr, yi
