"""Float64-oracle parity of the split-plane transforms, at the sizes and
batch shapes users run: powers of two from 2^10 to 2^23, 3·2^k and 5·2^k
composites, primes (chirp-z) and batched shapes.

Every transform computes in float32 with its contractions at
Precision.HIGHEST, which lands near 130 dB against float64, so each
check must reach SNR_DB = 100 dB (a contraction that slipped to TF32
would land near 60 dB). Chirp-z sizes must reach 90 dB: the chirp phases
grow as k^2 and the convolution runs at twice the length.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fftlab.core.types import FORWARD, INVERSE
from fftlab.plan.api import (
    plan_c2r_1d_split,
    plan_dft_1d_split,
    plan_r2c_1d_split,
)
from fftlab.plan.dispatch import fft_split_auto

SNR_DB = 100.0
CHIRP_SNR_DB = 90.0

POW2 = [1 << k for k in range(10, 24)]
COMPOSITE = [3 << 8, 3 << 12, 3 << 16, 5 << 10]
PRIMES = [1009, 10007, 131071, 500009]
BATCHED = [(4, 1 << 12), (2, 3, 1 << 10), (16, 1 << 14), (8, 3 << 10)]


def snr_db(got, want) -> float:
    err = np.sum(np.abs(got - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return (z, jnp.asarray(np.ascontiguousarray(z.real)),
            jnp.asarray(np.ascontiguousarray(z.imag)))


def _join(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _tol(n):
    from fftlab.algos.stockham import max_prime_factor
    from fftlab.algos.split_stockham import DEFAULT_LEAF_SPLIT

    return CHIRP_SNR_DB if max_prime_factor(n) > DEFAULT_LEAF_SPLIT else SNR_DB


def _id(shape):
    return "x".join(str(d) for d in shape)


FORWARD_SHAPES = ([(n,) for n in POW2 + COMPOSITE + PRIMES] + BATCHED)
INVERSE_SHAPES = ([(n,) for n in POW2 if n <= 1 << 20]
                  + [(n,) for n in COMPOSITE + PRIMES[:3]] + BATCHED)


@pytest.mark.parametrize("shape", FORWARD_SHAPES, ids=_id)
def test_fft_split_auto_forward(shape):
    z, xr, xi = _signal(shape, seed=len(shape) + shape[-1] % 97)
    got = _join(*fft_split_auto(xr, xi))
    want = np.fft.fft(z.astype(np.complex128), axis=-1)
    assert got.shape == want.shape
    assert snr_db(got, want) >= _tol(shape[-1])


@pytest.mark.parametrize("shape", INVERSE_SHAPES, ids=_id)
def test_fft_split_auto_inverse(shape):
    z, xr, xi = _signal(shape, seed=3 + shape[-1] % 89)
    got = _join(*fft_split_auto(xr, xi, INVERSE))
    want = np.fft.ifft(z.astype(np.complex128), axis=-1)
    assert snr_db(got, want) >= _tol(shape[-1])


@pytest.mark.parametrize("direction", [FORWARD, INVERSE],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [1 << 10, 1 << 14, 1 << 17, 1 << 20,
                               3 << 8, 3 << 12, 10007])
def test_split_plan_both_directions(n, direction):
    z, xr, xi = _signal((2, n), seed=n % 101)
    plan = plan_dft_1d_split(n, direction, batch=2)
    got = _join(*plan.execute((xr, xi)))
    zc = z.astype(np.complex128)
    want = (np.fft.fft(zc, axis=-1) if direction == FORWARD
            else np.fft.ifft(zc, axis=-1))
    assert snr_db(got, want) >= _tol(n)


REAL_SIZES = ([1 << k for k in range(10, 23)]
              + [3 << 12, 6 << 10, 15, 1001])


@pytest.mark.parametrize("n", REAL_SIZES)
def test_r2c_plan_matches_rfft(n):
    x = np.random.default_rng(n % 103).standard_normal((3, n)).astype(
        np.float32)
    Xr, Xi = plan_r2c_1d_split(n, batch=3).execute(jnp.asarray(x))
    got = _join(Xr, Xi)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert got.shape == want.shape == (3, n // 2 + 1)
    assert snr_db(got, want) >= _tol(n if n % 2 else max(n // 2, 1))


@pytest.mark.parametrize("n", REAL_SIZES)
def test_c2r_plan_matches_irfft(n):
    x = np.random.default_rng(n % 107).standard_normal((3, n))
    X = np.fft.rfft(x, axis=-1)
    y = plan_c2r_1d_split(n, batch=3).execute(
        (jnp.asarray(X.real, jnp.float32), jnp.asarray(X.imag, jnp.float32)))
    assert np.asarray(y).shape == (3, n)
    assert snr_db(np.asarray(y, np.float64), x) >= _tol(
        n if n % 2 else max(n // 2, 1))
