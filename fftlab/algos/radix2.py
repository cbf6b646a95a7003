"""Radix-2 Cooley-Tukey: decimation-in-time and decimation-in-frequency.

The analog of reference algorithms/core/radix2_dit.c:59-138 and
radix2_dif.c:15-51 — but vectorized for the VPU instead of the reference's
scalar butterfly triple-loop (radix2_dit.c:84-112):

- the bit-reversal permutation is ONE gather with a host-precomputed index
  table (vs the reference's element-swap loop, radix2_dit.c:70-77);
- each of the log2(n) stages is expressed as a whole-array reshape +
  broadcasted twiddle multiply + concat, i.e. every butterfly in a stage
  executes in one fused VPU pass (the pthread stage-parallelism of
  parallel_fft.c:130-210 is subsumed by XLA vectorization);
- n is static under jit, so the stage loop is a Python loop that unrolls
  into a fixed compiled pipeline.

For the flagship matmul-based path see algos/stockham.py; this family is the
faithful radix-2 capability (and stays useful for odd shapes and tests).
"""

from __future__ import annotations

import jax.numpy as jnp

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.bitrev import bit_reverse_indices
from fftlab.core.twiddle import butterfly_twiddle_np
from fftlab.core.types import FORWARD, is_power_of_two, log2_int


def _check_pow2(n: int):
    if not is_power_of_two(n):
        raise ValueError(f"radix-2 FFT requires power-of-two size, got n={n}")


def radix2_dit_unscaled(x, direction=FORWARD):
    """DIT butterfly passes without the inverse 1/n scale (used as the leaf
    kernel by split-radix/Bluestein, which scale once at the top)."""
    x, n, direction = prepare(x, direction)
    _check_pow2(n)
    if n == 1:
        return x
    batch = x.shape[:-1]

    x = jnp.take(x, jnp.asarray(bit_reverse_indices(n)), axis=-1)
    for s in range(1, log2_int(n) + 1):
        m = 1 << s
        w = const(butterfly_twiddle_np(m, direction), x)  # [m/2]
        x = x.reshape(*batch, n // m, m)
        even = x[..., : m // 2]
        t = x[..., m // 2 :] * w
        x = jnp.concatenate([even + t, even - t], axis=-1)
    return x.reshape(*batch, n)


def radix2_dit(x, direction=FORWARD):
    """Iterative radix-2 DIT (radix2_dit.c:59-124): bit-reverse, then
    log2(n) Danielson-Lanczos stages of vectorized butterflies."""
    x, n, direction = prepare(x, direction)
    return inverse_scale(radix2_dit_unscaled(x, direction), n, direction)


def radix2_dif(x, direction=FORWARD):
    """Radix-2 DIF (radix2_dif.c:15-51): butterflies with stages descending,
    bit-reversal applied AFTER the butterfly passes."""
    x, n, direction = prepare(x, direction)
    _check_pow2(n)
    if n == 1:
        return x
    batch = x.shape[:-1]

    for s in range(log2_int(n), 0, -1):
        m = 1 << s
        w = const(butterfly_twiddle_np(m, direction), x)  # [m/2]
        x = x.reshape(*batch, n // m, m)
        a = x[..., : m // 2]
        b = x[..., m // 2 :]
        x = jnp.concatenate([a + b, (a - b) * w], axis=-1)
    x = x.reshape(*batch, n)
    x = jnp.take(x, jnp.asarray(bit_reverse_indices(n)), axis=-1)
    return inverse_scale(x, n, direction)


def fft_radix2_dit(x):
    """Forward wrapper (fft_algorithms.h:14)."""
    return radix2_dit(x, FORWARD)


def ifft_radix2_dit(x):
    """Inverse wrapper with 1/n scaling (fft_algorithms.h:15)."""
    from fftlab.core.types import INVERSE

    return radix2_dit(x, INVERSE)


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("radix2_dit", radix2_dit)
