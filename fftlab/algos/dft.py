"""Reference DFTs: the O(n^2) correctness oracle and the cached-twiddle
variant, plus a Goertzel single-bin evaluator.

The analog of reference algorithms/dft/naive_dft.c:55-97 and
optimized_dft.c:29-163 + goertzel_single_bin (optimized_dft.c:106-126).

The "naive" O(n^2) DFT is simply a matmul against the full DFT matrix,
so for small/medium n this oracle is *also* a fast path (stockham.py
uses the same matmul as its leaf codelet). Every contraction runs at
Precision.HIGHEST: a GPU would otherwise be free to use TF32. `naive_dft` is the ground-truth oracle the whole test
matrix compares against, mirroring tests/test_all.c:58.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.twiddle import dft_matrix_np
from fftlab.core.types import Direction, FORWARD, as_complex_array, real_dtype_for

_PRECISION = jax.lax.Precision.HIGHEST


def naive_dft(x, direction=FORWARD):
    """Textbook O(n^2) DFT: X[k] = sum_j x[j] * exp(2*pi*i*dir*j*k/n).

    (naive_dft.c:55-97.) One matmul against the precomputed DFT matrix.
    """
    x, n, direction = prepare(x, direction)
    F = const(dft_matrix_np(n, direction), x)
    y = jnp.einsum("...j,jk->...k", x, F, precision=_PRECISION)
    return inverse_scale(y, n, direction)


def optimized_dft(x, direction=FORWARD):
    """Cached-twiddle DFT with a real-input half-spectrum fast path.

    (optimized_dft.c:29-163: full twiddle cache + X[n-k]=conj(X[k]) symmetry
    for real inputs.) For complex input this is the same matmul as
    `naive_dft`; for real input only n/2+1 output bins are computed and the
    rest mirrored by Hermitian symmetry — half the matmul work.
    """
    xin = jnp.asarray(x)
    if np.dtype(xin.dtype).kind != "c":
        return _real_input_dft(xin, direction)
    x, n, direction = prepare(x, direction)
    F = const(dft_matrix_np(n, direction), x)
    y = jnp.einsum("...j,jk->...k", x, F, precision=_PRECISION)
    return inverse_scale(y, n, direction)


def _real_input_dft(x, direction):
    """Half-spectrum DFT for real input (optimized_dft.c:80-103)."""
    x, n, direction = prepare(x, direction)
    h = n // 2 + 1
    F = const(dft_matrix_np(n, direction)[:, :h], x)
    half = jnp.einsum("...j,jk->...k", x, F,
                      precision=_PRECISION)  # bins 0..n/2
    if n > 1:
        mirror = jnp.conj(half[..., 1 : n - h + 1][..., ::-1])
        y = jnp.concatenate([half, mirror], axis=-1)
    else:
        y = half
    return inverse_scale(y, n, direction)


def goertzel(x, k, direction=FORWARD):
    """Goertzel single-bin DFT: X[k] via the second-order recurrence
    s[j] = x[j] + 2*cos(w)*s[j-1] - s[j-2] (optimized_dft.c:106-126).

    Implemented as a `lax.scan` (the recurrence is inherently sequential);
    batched over leading axes. Returns the complex bin value X[k].
    """
    x = as_complex_array(x)
    n = int(x.shape[-1])
    w = 2.0 * np.pi * float(k) / n
    coeff = jnp.asarray(2.0 * np.cos(w), dtype=real_dtype_for(x.dtype))

    def step(carry, xj):
        s1, s2 = carry
        s = xj + coeff * s1 - s2
        return (s, s1), None

    zeros = jnp.zeros(x.shape[:-1], dtype=x.dtype)
    (s1, s2), _ = jax.lax.scan(step, (zeros, zeros), jnp.moveaxis(x, -1, 0))
    # Closing formula (resonator form): X[k] = e^{iw}*s[n-1] - s[n-2] with
    # w = 2*pi*k/n for the forward transform; in the direction-parameterized
    # basis the phase is exp(-2*pi*i*direction*k/n).
    phase = np.exp(-2j * np.pi * float(int(Direction(int(direction)))) * float(k) / n)
    wk = jnp.asarray(np.asarray(phase), dtype=x.dtype)
    # Package convention (algos/__init__.py): inverse is 1/n scaled.
    return inverse_scale(wk * s1 - s2, n, direction)


def dft_bin(x, k, direction=FORWARD):
    """Direct single-bin DFT (dot with one twiddle row) — the vectorized
    alternative to `goertzel` when sequential semantics aren't needed."""
    x = as_complex_array(x)
    n = int(x.shape[-1])
    j = np.arange(n, dtype=np.int64)
    row = np.exp(2j * np.pi * float(int(Direction(int(direction)))) * np.mod(j * int(k), n) / n)
    return inverse_scale(jnp.einsum("...j,j->...", x, const(row, x),
                                    precision=_PRECISION),
                         n, direction)


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("naive_dft (oracle)", naive_dft, sizes=(16, 64, 256))
