"""Bit- and digit-reversal permutation tables.

The analog of the reference's `bit_reverse()` (fft_common.h:59-77)
and the planner's bit-reverse table (fft_auto.c:206-212).

On an accelerator a per-element scatter (radix2_dit.c:70-77) is slow;
instead the permutation is a host-precomputed index table applied as ONE
gather (`jnp.take`), which XLA lowers to one device-memory gather.
The flagship Stockham matmul path avoids reversal entirely; these tables
exist for the classic DIT/DIF algorithm family and for tests.
"""

from __future__ import annotations

import functools

import numpy as np

from fftlab.core.types import is_power_of_two, log2_int


@functools.lru_cache(maxsize=None)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reverse of i in log2(n) bits (int32)."""
    if not is_power_of_two(n):
        raise ValueError(f"bit_reverse_indices requires power-of-two n, got {n}")
    bits = log2_int(n)
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=None)
def digit_reverse_indices(n: int, radix: int) -> np.ndarray:
    """Permutation reversing the base-`radix` digits of each index (int32).

    Generalizes bit reversal for radix-4 / mixed-power transforms
    (radix4.c digit ordering)."""
    digits = 0
    m = n
    while m > 1:
        if m % radix != 0:
            raise ValueError(f"{n} is not a power of {radix}")
        m //= radix
        digits += 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    tmp = idx.copy()
    for _ in range(digits):
        rev = rev * radix + (tmp % radix)
        tmp //= radix
    return rev.astype(np.int32)
