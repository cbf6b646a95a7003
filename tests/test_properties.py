"""Property-based conformance matrix over (algorithm x size).

The analog of the reference's test suite (tests/test_all.c:64-442):
the same seven properties — impulse, DC, linearity, Parseval, round-trip,
known cosine pair, numerical stability — generic over the algorithm
registry with per-algorithm size constraints (test_all.c:50-59), plus the
naive-DFT float64 oracle comparison (test_all.c:58).

Tolerances follow the reference: 1e-10 for float64 (test_all.c:498),
1e-5 for float32 paths (simd_fft.c:362).
"""

import numpy as np
import pytest

from fftlab.algos import build_registry
from fftlab.algos.dft import naive_dft
from fftlab.core.types import FORWARD, INVERSE
from fftlab.utils.signals import generate_complex_noise

REGISTRY = build_registry()

POW2_SIZES = [2, 4, 8, 16, 64, 256, 1024]
COMPOSITE_SIZES = [6, 12, 15, 20, 24, 30, 60, 100, 360]
PRIME_SIZES = [7, 13, 97, 251]

TOL_F64 = 1e-10
TOL_F32 = 1e-5


def base_tol(name: str) -> float:
    return TOL_F64


# Educational algorithms trace O(n) nodes — cap their test sizes.
SIZE_CAP = {"recursive": 256, "iterative": 1024}


def cases():
    out = []
    for name, spec in REGISTRY.items():
        cap = SIZE_CAP.get(name, 10**9)
        for n in POW2_SIZES + COMPOSITE_SIZES + PRIME_SIZES:
            if spec.supports(n) and n <= cap:
                out.append((name, n))
    return out


CASES = cases()


def run(name, x, direction=FORWARD):
    return np.asarray(REGISTRY[name].fn(x, direction))


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_impulse(name, n):
    """FFT(impulse) = all-ones (test_all.c:64-96)."""
    x = np.zeros(n, dtype=np.complex128)
    x[0] = 1.0
    X = run(name, x)
    np.testing.assert_allclose(X, np.ones(n), atol=base_tol(name) * 8)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_dc(name, n):
    """FFT(ones): X[0]=n, rest 0 (test_all.c:99-144)."""
    x = np.ones(n, dtype=np.complex128)
    X = run(name, x)
    expected = np.zeros(n, dtype=np.complex128)
    expected[0] = n
    np.testing.assert_allclose(X, expected, atol=base_tol(name) * max(n, 1))


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_matches_naive_dft_oracle(name, n):
    """Ground truth: the O(n^2) float64 DFT (test_all.c:58 oracle role)."""
    x = generate_complex_noise(n, seed=n)
    X = run(name, x)
    ref = np.asarray(naive_dft(x))
    np.testing.assert_allclose(X, ref, atol=base_tol(name) * n, rtol=1e-9)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_linearity(name, n):
    """FFT(2a+3b) = 2*FFT(a)+3*FFT(b) (test_all.c:147-195)."""
    a = generate_complex_noise(n, seed=1)
    b = generate_complex_noise(n, seed=2)
    lhs = run(name, 2.0 * a + 3.0 * b)
    rhs = 2.0 * run(name, a) + 3.0 * run(name, b)
    np.testing.assert_allclose(lhs, rhs, atol=base_tol(name) * n)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_parseval(name, n):
    """sum|x|^2 = sum|X|^2 / n (test_all.c:198-244)."""
    x = generate_complex_noise(n, seed=3)
    X = run(name, x)
    e_time = np.sum(np.abs(x) ** 2)
    e_freq = np.sum(np.abs(X) ** 2) / n
    assert abs(e_time - e_freq) < base_tol(name) * n * 10, (e_time, e_freq)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_roundtrip(name, n):
    """IFFT(FFT(x)) = x (test_all.c:247-287)."""
    x = generate_complex_noise(n, seed=4)
    y = run(name, run(name, x), INVERSE)
    np.testing.assert_allclose(y, x, atol=base_tol(name) * n)


@pytest.mark.parametrize(
    "name,n",
    [(a, n) for a, n in CASES if n >= 16],
    ids=[f"{a}-{n}" for a, n in CASES if n >= 16],
)
def test_known_cosine_pair(name, n):
    """cos(2*pi*f*k/n) -> peaks n/2 at bins +/-f (test_all.c:290-351)."""
    f = 3
    k = np.arange(n)
    x = np.cos(2 * np.pi * f * k / n).astype(np.complex128)
    X = run(name, x)
    expected = np.zeros(n, dtype=np.complex128)
    expected[f] = n / 2
    expected[n - f] = n / 2
    np.testing.assert_allclose(X, expected, atol=base_tol(name) * n * 10)


@pytest.mark.parametrize("name", sorted({a for a, _ in CASES}))
def test_stability_10x_roundtrip(name):
    """10 fwd/inv cycles on wide-dynamic-range data: rel err < 1e-6
    (test_all.c:354-404)."""
    for n in (64, 60, 1024):
        if REGISTRY[name].supports(n):
            break
    else:
        pytest.skip(f"{name} supports none of the stability sizes")
    rng = np.random.default_rng(0)
    scales = 10.0 ** rng.uniform(-5, 5, n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scales
    y = x
    for _ in range(10):
        y = run(name, run(name, y), INVERSE)
    # Error relative to the signal scale: per-element relative error on
    # 10-decade dynamic-range data is ~1e10*eps for ANY float64 FFT (the
    # small elements absorb roundoff proportional to the array norm), so
    # the meaningful stability criterion is scale-relative.
    rel = np.max(np.abs(y - x)) / np.max(np.abs(x))
    assert rel < 1e-6, rel


@pytest.mark.parametrize("name,n", [(a, n) for a, n in CASES if n == 64])
def test_batched_matches_single(name, n):
    """Batch-first API: [B, n] equals per-row transforms."""
    x = generate_complex_noise(n, seed=5, batch=(3,))
    X = run(name, x)
    for i in range(3):
        np.testing.assert_allclose(X[i], run(name, x[i]), atol=base_tol(name) * n)


@pytest.mark.parametrize("name,n", [(a, n) for a, n in CASES if n == 256])
def test_float32_tolerance(name, n):
    """float32 path stays within the reference's SIMD tolerance
    (simd_fft.c:362: 1e-5, relative to peak magnitude)."""
    x = generate_complex_noise(n, seed=6).astype(np.complex64)
    X = run(name, x)
    assert X.dtype == np.complex64
    ref = np.asarray(naive_dft(x.astype(np.complex128)))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(X - ref)) / scale < TOL_F32
