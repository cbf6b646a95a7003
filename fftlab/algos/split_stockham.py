"""Split re/im (structure-of-arrays) Stockham FFT — the device path.

Complex data is carried as two real float32 arrays, the layout the
reference's SIMD track chose (simd_fft.c:92-109, split re/im SoA).

Same algorithm as algos/stockham.py (mixed-radix digit decomposition, one
matmul per stage, digit-reversal as a single final transpose), with
every complex operation expanded into real arithmetic:

- stage contraction: (yr + i·yi) = (xr + i·xi) @ (Fr + i·Fi)^T becomes
  four real einsums at Precision.HIGHEST. On the GPU a float32 matmul
  without a stated precision may run in TF32 (10-bit mantissa), which
  costs some 60 dB of SNR on a 1M-point transform; HIGHEST keeps it in
  float32.
- twiddle multiply: one fused elementwise complex multiply on real
  planes.

The default leaf is 128 (not 1024 as on the complex path): per-stage
flops are 8·n·r, so a smaller radix does less arithmetic per pass at the
cost of more passes. Measured leaf wisdom (plan/split_tuning.py)
overrides it per size on the running device.
"""

from __future__ import annotations

import functools
import string

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.algos.stockham import plan_factors
from fftlab.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab.core.types import Direction, FORWARD

DEFAULT_LEAF_SPLIT = 128

_PRECISION = jax.lax.Precision.HIGHEST


def to_split(x):
    """complex [..., n] -> (re, im) real pair (host/CPU boundary helper)."""
    x = np.asarray(x)
    r = np.ascontiguousarray(x.real)
    i = np.ascontiguousarray(x.imag)
    return jnp.asarray(r), jnp.asarray(i)


def from_split(xr, xi):
    """(re, im) -> complex array (host-side; avoids device complex)."""
    return np.asarray(xr) + 1j * np.asarray(xi)


def _tables(r: int, direction: Direction, dtype):
    F = dft_matrix_np(r, direction)
    return (
        jnp.asarray(F.real.astype(dtype)),
        jnp.asarray(F.imag.astype(dtype)),
    )


def _contract_split(xr, xi, Fr, Fi, axis_from_end: int, precision=None):
    """Complex contraction of one digit axis, expanded to real einsums
    (at HIGHEST unless the caller passes a precision)."""
    if axis_from_end == 0:
        eq = "...a,ba->...b"
    else:
        tail = string.ascii_lowercase[2 : 2 + axis_from_end]
        eq = f"...a{tail},ba->...b{tail}"
    ein = functools.partial(jnp.einsum, eq,
                            precision=precision or _PRECISION)
    yr = ein(xr, Fr) - ein(xi, Fi)
    yi = ein(xr, Fi) + ein(xi, Fr)
    return yr, yi


def _twiddle_split(xr, xi, twr, twi):
    """(x) *= (twr + i*twi), real planes (fused elementwise multiply-add)."""
    yr = xr * twr - xi * twi
    yi = xr * twi + xi * twr
    return yr, yi


def stockham_fft_split_unscaled(xr, xi, direction=FORWARD,
                                leaf: int = DEFAULT_LEAF_SPLIT,
                                precision=None):
    """Forward/backward transform on split planes, no inverse scaling.

    `precision` overrides the matmul precision (default HIGHEST;
    see algos/lowprec.py for the accuracy/speed trade)."""
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    if xr.shape != xi.shape:
        raise ValueError(f"re/im shape mismatch: {xr.shape} vs {xi.shape}")
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    dtype = np.dtype(xr.dtype)
    if n == 1:
        return xr, xi
    factors = plan_factors(n, leaf)
    K = len(factors)
    if K == 1:
        Fr, Fi = _tables(n, direction, dtype)
        return _contract_split(xr, xi, Fr, Fi, 0, precision)

    batch = xr.shape[:-1]
    bnd = len(batch)
    xr = xr.reshape(*batch, *factors)
    xi = xi.reshape(*batch, *factors)
    rem = n
    for i, r in enumerate(factors):
        Fr, Fi = _tables(r, direction, dtype)
        xr, xi = _contract_split(xr, xi, Fr, Fi, K - 1 - i, precision)
        if i < K - 1:
            m = rem // r
            tw = stage_twiddle_np(r, m, direction).reshape(r, *factors[i + 1 :])
            twr = jnp.asarray(tw.real.astype(dtype))
            twi = jnp.asarray(tw.imag.astype(dtype))
            xr, xi = _twiddle_split(xr, xi, twr, twi)
            rem = m
    perm = tuple(range(bnd)) + tuple(range(bnd + K - 1, bnd - 1, -1))
    xr = jnp.transpose(xr, perm).reshape(*batch, n)
    xi = jnp.transpose(xi, perm).reshape(*batch, n)
    return xr, xi


def fft_split(xr, xi, direction=FORWARD, leaf: int = DEFAULT_LEAF_SPLIT,
              precision=None):
    """Split-complex FFT over the last axis: (re, im) -> (re, im).

    Forward unscaled; inverse scaled by 1/n (reference convention,
    radix2_dit.c:115-119).
    """
    direction = Direction(int(direction))
    n = int(jnp.asarray(xr).shape[-1])
    from fftlab.algos.stockham import max_prime_factor

    if n > 1 and max_prime_factor(n) > leaf:
        # Prime factor beyond the leaf: chirp-z territory
        # (mirrors the planner's routing, fft_auto.c:136-172 semantics).
        from fftlab.algos.bluestein import bluestein_fft_split

        return bluestein_fft_split(xr, xi, direction)
    yr, yi = stockham_fft_split_unscaled(xr, xi, direction, leaf, precision)
    if direction == Direction.INVERSE:
        s = jnp.asarray(1.0 / n, dtype=yr.dtype)
        return yr * s, yi * s
    return yr, yi


def ifft_split(xr, xi, leaf: int = DEFAULT_LEAF_SPLIT):
    return fft_split(xr, xi, Direction.INVERSE, leaf)


def rfft_split(x, leaf: int = DEFAULT_LEAF_SPLIT, cfft=None):
    """Real-input FFT on the split path: real [..., n] -> (re, im) of the
    n//2+1 one-sided bins, via the pack-two-reals trick (real_fft.py
    semantics without any complex dtype). The r2c the reference declared
    but never shipped (fft_auto.c:391-403 use-after-free).

    The Hermitian unpack is PAIRED when m = n/2 is even: bins k and m-k
    are emitted together from one E[k], W[k]*O[k] computation, so the
    half-size spectrum Z is read once instead of twice (natural +
    conj-reversed) and every intermediate is m/2-sized — half the
    unpack's memory traffic.

    `cfft(re, im) -> (re, im)` overrides the half-size complex transform
    (e.g. a dispatch route, as plan_r2c_1d_split passes)."""
    if cfft is None:
        cfft = lambda a, b: fft_split(a, b, FORWARD, leaf)
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    h = n // 2 + 1
    if n % 2 or n < 4:
        zr, zi = fft_split(x, jnp.zeros_like(x), FORWARD, leaf)
        return zr[..., :h], zi[..., :h]
    zr_in, zi_in = x[..., 0::2], x[..., 1::2]
    Zr, Zi = cfft(zr_in, zi_in)
    m = n // 2
    if m % 2 == 0:
        # PAIRED unpack: bins k and m-k share E[k], W[k]*O[k] —
        #   X[k]   = E + W*O            (k = 0..m/2)
        #   X[m-k] = conj(E - W*O)      (k = 1..m/2-1), X[m] from k=0
        # so Z is read ONCE (the naive full-range unpack reads it twice:
        # natural + conj-reversed) and every intermediate is m/2-sized.
        half = m // 2
        Zlr, Zli = Zr[..., : half + 1], Zi[..., : half + 1]
        # Zh[k] = Z[(m-k) % m] for k = 0..m/2:  [Z[0], Z[m-1]..Z[m/2]]
        Zhr = jnp.concatenate(
            [Zr[..., :1], Zr[..., half:][..., ::-1]], axis=-1)
        Zhi = jnp.concatenate(
            [Zi[..., :1], Zi[..., half:][..., ::-1]], axis=-1)
        Er, Ei = 0.5 * (Zlr + Zhr), 0.5 * (Zli - Zhi)
        Or_ = 0.5 * (Zli + Zhi)
        Oi = -0.5 * (Zlr - Zhr)
        k = np.arange(half + 1, dtype=np.float64)
        w = np.exp(-2j * np.pi * k / n)
        wr = jnp.asarray(w.real.astype(x.dtype))
        wi = jnp.asarray(w.imag.astype(x.dtype))
        WOr, WOi = _twiddle_split(Or_, Oi, wr, wi)
        low_r, low_i = Er + WOr, Ei + WOi            # bins 0..m/2
        hr_, hi_ = Er - WOr, -(Ei - WOi)             # conj(E - W*O)
        # bins m/2+1..m-1 ascending = k = m/2-1 .. 1
        mid_r = hr_[..., 1:half][..., ::-1]
        mid_i = hi_[..., 1:half][..., ::-1]
        Xr_out = jnp.concatenate([low_r, mid_r, hr_[..., :1]], axis=-1)
        Xi_out = jnp.concatenate([low_i, mid_i, hi_[..., :1]], axis=-1)
        return Xr_out, Xi_out
    Zr = jnp.concatenate([Zr, Zr[..., :1]], axis=-1)
    Zi = jnp.concatenate([Zi, Zi[..., :1]], axis=-1)
    # conj reversal: Zrev[k] = conj(Z[n/2 - k])
    Zrr, Zri = Zr[..., ::-1], -Zi[..., ::-1]
    Er, Ei = 0.5 * (Zr + Zrr), 0.5 * (Zi + Zri)
    # O = -0.5i * (Z - Zrev)
    Or_ = 0.5 * (Zi - Zri)
    Oi = -0.5 * (Zr - Zrr)
    k = np.arange(h, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / n)
    wr = jnp.asarray(w.real.astype(x.dtype))
    wi = jnp.asarray(w.imag.astype(x.dtype))
    WOr, WOi = _twiddle_split(Or_, Oi, wr, wi)
    return Er + WOr, Ei + WOi


def irfft_split(Xr, Xi, n: int | None = None,
                leaf: int = DEFAULT_LEAF_SPLIT, cfft=None):
    """One-sided (re, im) spectrum -> real [..., n] (inverse of
    rfft_split; 1/n scaled).

    `cfft(re, im) -> (re, im)` overrides the half-size INVERSE complex
    transform (must apply the usual 1/(n/2) inverse normalization, e.g.
    an INVERSE dispatch route, as plan_c2r_1d_split passes).
    """
    Xr = jnp.asarray(Xr)
    Xi = jnp.asarray(Xi)
    h = int(Xr.shape[-1])
    if n is None:
        n = 2 * (h - 1)
    if n % 2 or n < 4:
        tr = Xr[..., 1 : n - h + 1][..., ::-1]
        ti = -Xi[..., 1 : n - h + 1][..., ::-1]
        fr = jnp.concatenate([Xr[..., :h], tr], axis=-1)
        fi = jnp.concatenate([Xi[..., :h], ti], axis=-1)
        yr, _ = fft_split(fr, fi, Direction.INVERSE, leaf)
        return yr
    m = n // 2
    if m % 2 == 0:
        # PAIRED repack (mirror of rfft_split's paired unpack): bins k
        # and m-k share E[k], W[k]*D[k] —
        #   Z[k]   = E + i*W*D          (k = 0..m/2)
        #   Z[m-k] = conj(E - i*W*D)    (k = 1..m/2-1)
        # so the spectrum is read ONCE and every intermediate is
        # m/2-sized.
        half = m // 2
        Xlr, Xli = Xr[..., : half + 1], Xi[..., : half + 1]
        Xhr = Xr[..., half:][..., ::-1]   # Xh[k] = X[m-k]
        Xhi = Xi[..., half:][..., ::-1]
        Er, Ei = 0.5 * (Xlr + Xhr), 0.5 * (Xli - Xhi)
        Dr = 0.5 * (Xlr - Xhr)
        Di = 0.5 * (Xli + Xhi)
        k = np.arange(half + 1, dtype=np.float64)
        w = np.exp(2j * np.pi * k / n)  # inverse basis
        wr = jnp.asarray(w.real.astype(Xr.dtype))
        wi = jnp.asarray(w.imag.astype(Xr.dtype))
        Or_, Oi = _twiddle_split(Dr, Di, wr, wi)
        low_r, low_i = Er - Oi, Ei + Or_             # Z bins 0..m/2
        hr_ = Er + Oi                                 # conj(E - i*O)
        hi_ = Or_ - Ei
        Zr = jnp.concatenate(
            [low_r, hr_[..., 1:half][..., ::-1]], axis=-1)
        Zi = jnp.concatenate(
            [low_i, hi_[..., 1:half][..., ::-1]], axis=-1)
    else:
        Xrr, Xri = Xr[..., ::-1], -Xi[..., ::-1]
        Er, Ei = 0.5 * (Xr + Xrr), 0.5 * (Xi + Xri)
        k = np.arange(h, dtype=np.float64)
        w = np.exp(2j * np.pi * k / n)  # inverse basis
        wr = jnp.asarray(w.real.astype(Xr.dtype))
        wi = jnp.asarray(w.imag.astype(Xr.dtype))
        Dr, Di = 0.5 * (Xr - Xrr), 0.5 * (Xi - Xri)
        Or_, Oi = _twiddle_split(Dr, Di, wr, wi)
        # Z = E + i*O
        Zr = (Er - Oi)[..., : n // 2]
        Zi = (Ei + Or_)[..., : n // 2]
    if cfft is None:
        cfft = lambda a, b: fft_split(a, b, Direction.INVERSE, leaf)
    zr, zi = cfft(Zr, Zi)
    out = jnp.stack([zr, zi], axis=-1)
    return out.reshape(*out.shape[:-2], n)


def spectral_filter_split(xr, xi, hr, hi, leaf: int = DEFAULT_LEAF_SPLIT):
    """The fused FFT -> H -> IFFT sandwich (SURVEY.md §3.4) on split
    planes — the flagship single-chip pipeline step."""
    Xr, Xi = stockham_fft_split_unscaled(xr, xi, FORWARD, leaf)
    Yr, Yi = _twiddle_split(Xr, Xi, hr, hi)
    n = int(jnp.asarray(xr).shape[-1])
    yr, yi = stockham_fft_split_unscaled(Yr, Yi, Direction.INVERSE, leaf)
    s = jnp.asarray(1.0 / n, dtype=yr.dtype)
    return yr * s, yi * s


# ---------------------------------------------------------------------------
# Transpose-free filter sandwich (DIF forward + mirrored DIT inverse)
# ---------------------------------------------------------------------------
#
# The forward pipeline above is decimation-in-frequency: its natural
# output order is digit-reversed, fixed by one big HBM transpose. For the
# FFT -> H -> IFFT sandwich that transpose (and its mirror image on the
# inverse side) is pure waste: the pointwise multiply doesn't care about
# bin order. So the fused filter runs the forward WITHOUT the final
# transpose, multiplies by a host-side digit-reversed copy of H, and
# inverts with the exact algebraic inverse of the stage pipeline — the
# stages applied backwards with conjugated tables (a DIT-style inverse
# that consumes digit-reversed input). Zero transposes end to end.


def _fft_split_digitrev(xr, xi, direction, factors, precision=None):
    """Forward stages only — output [..., n] in digit-reversed order
    (axes (k_0..k_{K-1}) flattened; spectrum bin k = k_0 + f_0*(k_1+...))."""
    batch = xr.shape[:-1]
    dtype = np.dtype(xr.dtype)
    K = len(factors)
    n = int(np.prod(factors))
    xr = xr.reshape(*batch, *factors)
    xi = xi.reshape(*batch, *factors)
    rem = n
    for i, r in enumerate(factors):
        Fr, Fi = _tables(r, direction, dtype)
        xr, xi = _contract_split(xr, xi, Fr, Fi, K - 1 - i, precision)
        if i < K - 1:
            m = rem // r
            tw = stage_twiddle_np(r, m, direction).reshape(r, *factors[i + 1:])
            xr, xi = _twiddle_split(
                xr, xi,
                jnp.asarray(tw.real.astype(dtype)),
                jnp.asarray(tw.imag.astype(dtype)),
            )
            rem = m
    return xr.reshape(*batch, n), xi.reshape(*batch, n)


def _ifft_split_from_digitrev(yr, yi, direction, factors, precision=None):
    """Exact inverse of `_fft_split_digitrev`: stages applied in reverse
    with conjugated tables. Consumes digit-reversed order, emits natural
    order. Unscaled (caller applies 1/n for a true inverse)."""
    inv_dir = Direction(-int(direction))
    batch = yr.shape[:-1]
    dtype = np.dtype(yr.dtype)
    K = len(factors)
    n = int(np.prod(factors))
    yr = yr.reshape(*batch, *factors)
    yi = yi.reshape(*batch, *factors)
    rem_sizes = []
    rem = n
    for r in factors:
        rem_sizes.append(rem)
        rem //= r
    for i in range(K - 1, -1, -1):
        r = factors[i]
        if i < K - 1:
            m = rem_sizes[i] // r
            tw = stage_twiddle_np(r, m, inv_dir).reshape(r, *factors[i + 1:])
            yr, yi = _twiddle_split(
                yr, yi,
                jnp.asarray(tw.real.astype(dtype)),
                jnp.asarray(tw.imag.astype(dtype)),
            )
        Fr, Fi = _tables(r, inv_dir, dtype)
        yr, yi = _contract_split(yr, yi, Fr, Fi, K - 1 - i, precision)
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


@functools.lru_cache(maxsize=None)
def digitrev_bins(factors: tuple) -> np.ndarray:
    """bins[p] = the spectrum bin held at row-major position p of the
    digit-reversed layout: p <-> digits (k_0..k_{K-1}) row-major, and
    bin = k_0 + f_0*(k_1 + f_1*(k_2 + ...)). So
    digitrev_output[..., p] == spectrum[..., bins[p]], and
    H[..., bins] is H in digit-reversed layout."""
    n = int(np.prod(factors))
    weights = []
    w = 1
    for f in factors:
        weights.append(w)
        w *= f
    pos_strides = []
    s = 1
    for f in reversed(factors):
        pos_strides.append(s)
        s *= f
    pos_strides = pos_strides[::-1]
    rem = np.arange(n)
    bins = np.zeros(n, dtype=np.int64)
    for i in range(len(factors)):
        k_i = rem // pos_strides[i]
        rem = rem % pos_strides[i]
        bins += k_i * weights[i]
    return bins


def permute_response(hr, hi, n: int, leaf: int = DEFAULT_LEAF_SPLIT):
    """Digit-reverse a frequency response at PLAN TIME (host-side).

    A runtime gather of H costs more than the transposes the fused path
    saves — permute once here and call `spectral_filter_split_fused`
    with `h_permuted=True`."""
    factors = plan_factors(n, leaf)
    if len(factors) == 1:
        return np.asarray(hr), np.asarray(hi)
    bins = digitrev_bins(factors)
    return (np.ascontiguousarray(np.asarray(hr)[..., bins]),
            np.ascontiguousarray(np.asarray(hi)[..., bins]))


def spectral_filter_split_fused(xr, xi, hr, hi,
                                leaf: int = DEFAULT_LEAF_SPLIT,
                                precision=None, h_permuted: bool = False):
    """FFT -> H -> IFFT with ZERO transposes: the pointwise multiply is
    done in digit-reversed bin order on a digit-reversed H.

    Pass H pre-permuted via `permute_response` + `h_permuted=True`
    whenever H is a plan-time constant; permuting a traced H at runtime
    is a full-size gather and erases the fusion win."""
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    n = int(xr.shape[-1])
    factors = plan_factors(n, leaf)
    if len(factors) == 1:
        return spectral_filter_split(xr, xi, hr, hi, leaf)
    if h_permuted:
        hr_p = jnp.asarray(hr)
        hi_p = jnp.asarray(hi)
    elif isinstance(hr, jax.core.Tracer) or isinstance(hi, jax.core.Tracer):
        bins = jnp.asarray(digitrev_bins(factors))
        hr_p = jnp.asarray(hr)[..., bins]
        hi_p = jnp.asarray(hi)[..., bins]
    else:
        hr_p, hi_p = map(jnp.asarray, permute_response(hr, hi, n, leaf))
    Yr, Yi = _fft_split_digitrev(xr, xi, FORWARD, factors, precision)
    Gr = Yr * hr_p - Yi * hi_p
    Gi = Yr * hi_p + Yi * hr_p
    zr, zi = _ifft_split_from_digitrev(Gr, Gi, FORWARD, factors, precision)
    s = jnp.asarray(1.0 / n, dtype=zr.dtype)
    return zr * s, zi * s


def fft2_split(xr, xi, direction=FORWARD, leaf: int = DEFAULT_LEAF_SPLIT,
               route: bool = False):
    """2D FFT on split planes over the last two axes (row-column
    decomposition, fft2d.py semantics without complex dtypes).

    `route=True` sends each axis's batched 1D transforms through the
    capability dispatch (plan/dispatch.fft_split_auto), which applies
    measured leaf wisdom per side; the default runs `leaf` directly.
    Every route uses the same forward-unscaled / inverse-1/n
    convention, so the per-axis inverse scalings compose to
    1/(rows*cols)."""
    direction = Direction(int(direction))
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    rows, cols = int(xr.shape[-2]), int(xr.shape[-1])
    if route:
        from fftlab.plan.dispatch import fft_split_auto

        yr, yi = fft_split_auto(xr, xi, direction)
        yr = jnp.swapaxes(yr, -1, -2)
        yi = jnp.swapaxes(yi, -1, -2)
        yr, yi = fft_split_auto(yr, yi, direction)
        return jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2)
    yr, yi = stockham_fft_split_unscaled(xr, xi, direction, leaf)
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    yr, yi = stockham_fft_split_unscaled(yr, yi, direction, leaf)
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    if direction == Direction.INVERSE:
        s = jnp.asarray(1.0 / (rows * cols), dtype=yr.dtype)
        return yr * s, yi * s
    return yr, yi
