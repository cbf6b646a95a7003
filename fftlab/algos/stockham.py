"""Flagship complex path: self-sorting mixed-radix FFT where every stage
is a batched matmul.

This is a re-design of the reference's hot loop (the radix-2 butterfly
triple-loop, radix2_dit.c:84-112) and of its four-step factorization
(parallel_fft.c:213-272), fused into one scheme:

- n is factored into radices (default <= 1024 each, e.g.
  2^20 -> 1024 x 1024). Each stage contracts one digit axis with the
  full radix-r DFT matrix — one dense matmul, at Precision.HIGHEST so a
  GPU keeps it in float32 rather than TF32 — then applies the
  inter-stage twiddles as one fused elementwise multiply.
- There is NO bit-reversal scatter anywhere (SURVEY.md §7 design stance):
  the digit permutation is absorbed into a single final transpose, which
  XLA lowers to an efficient tiled HBM transpose.
- Stage twiddles and DFT matrices are float64-computed plan-time constants
  (core/twiddle.py), cached per (n, direction).

Cost model (1M points, factors 1024x1024): 2 matmul passes of
8*n*1024 flops each + 1 transpose, vs 20 bandwidth-bound butterfly
passes for literal radix-2. Arbitrary
composite n works too (factors grouped from the prime factorization);
large-prime n belongs to Bluestein (the planner routes it there, and
Bluestein itself uses THIS transform for its internal power-of-two FFTs).

Derivation (digit decomposition): write j with mixed-radix digits
j = (((j_0)*r_1 + j_1)*r_2 + ...) and apply the two-factor Cooley-Tukey
identity recursively; after stage i the i-th axis holds output digit k_i,
and the output index is k = k_0 + r_0*(k_1 + r_1*(k_2 + ...)), i.e. the
computed tensor C[k_0, ..., k_{K-1}] must be read digit-reversed — the
final transpose.
"""

from __future__ import annotations

import functools
import string

import jax
import jax.numpy as jnp

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab.core.types import FORWARD, is_power_of_two

DEFAULT_LEAF = 1024

_PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def max_prime_factor(n: int) -> int:
    from fftlab.algos.mixed_radix import factorize

    return max(factorize(n)) if n > 1 else 1


@functools.lru_cache(maxsize=None)
def plan_factors(n: int, leaf: int = DEFAULT_LEAF) -> tuple[int, ...]:
    """Factor n into matmul-sized radices, each <= leaf.

    Powers of two split into near-equal power-of-two radices (2^20 ->
    1024*1024, 2^14 -> 128*128); general composites greedily group prime
    factors. Raises if a prime factor exceeds `leaf` (Bluestein territory).
    """
    if n < 1:
        raise ValueError(f"invalid transform size {n}")
    if n <= leaf:
        return (n,)
    if is_power_of_two(n):
        e = n.bit_length() - 1
        le = leaf.bit_length() - 1
        k = -(-e // le)  # ceil
        base, rem = divmod(e, k)
        return tuple([2 ** (base + 1)] * rem + [2**base] * (k - rem))
    from fftlab.algos.mixed_radix import factorize

    primes = sorted(factorize(n), reverse=True)
    if primes[0] > leaf:
        raise ValueError(
            f"n={n} has prime factor {primes[0]} > leaf {leaf}; use Bluestein"
        )
    groups: list[int] = []
    for p in primes:
        placed = False
        for i, g in enumerate(groups):
            if g * p <= leaf:
                groups[i] = g * p
                placed = True
                break
        if not placed:
            groups.append(p)
    return tuple(sorted(groups, reverse=True))


def _contract_digit(x, F, axis_from_end: int):
    """Contract the DFT matrix F[out, in] with one digit axis of x.

    axis_from_end: 0 = last axis, 1 = second-to-last, ...
    """
    if axis_from_end == 0:
        return jnp.einsum("...a,ba->...b", x, F, precision=_PRECISION)
    tail = string.ascii_lowercase[2 : 2 + axis_from_end]
    return jnp.einsum(f"...a{tail},ba->...b{tail}", x, F,
                      precision=_PRECISION)


def stockham_fft_unscaled(x, direction=FORWARD, leaf: int = DEFAULT_LEAF):
    """The transform without inverse 1/n scaling (internal building block)."""
    x, n, direction = prepare(x, direction)
    if n == 1:
        return x
    factors = plan_factors(n, leaf)
    K = len(factors)
    if K == 1:
        return _contract_digit(x, const(dft_matrix_np(n, direction), x), 0)

    batch = x.shape[:-1]
    bnd = len(batch)
    x = x.reshape(*batch, *factors)
    rem = n
    for i, r in enumerate(factors):
        F = const(dft_matrix_np(r, direction), x)
        x = _contract_digit(x, F, K - 1 - i)
        if i < K - 1:
            m = rem // r
            tw = stage_twiddle_np(r, m, direction).reshape(r, *factors[i + 1 :])
            x = x * const(tw, x)
            rem = m
    # Digit-reversed readout: transpose factor axes, single HBM transpose.
    perm = tuple(range(bnd)) + tuple(range(bnd + K - 1, bnd - 1, -1))
    x = jnp.transpose(x, perm)
    return x.reshape(*batch, n)


def stockham_fft(x, direction=FORWARD, leaf: int = DEFAULT_LEAF):
    """Flagship mixed-radix matmul FFT (any n whose prime factors are <= leaf)."""
    x, n, direction = prepare(x, direction)
    y = stockham_fft_unscaled(x, direction, leaf)
    return inverse_scale(y, n, direction)


def supports(n: int, leaf: int = DEFAULT_LEAF) -> bool:
    return n >= 1 and max_prime_factor(n) <= leaf


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("stockham_fft", stockham_fft)
