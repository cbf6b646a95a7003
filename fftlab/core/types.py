"""Core types and small integer/shape helpers.

The analog of the reference's `include/fft_common.h` (complex type,
direction enum, power-of-two predicates, bit-reversal; fft_common.h:28-77).

Design notes:
- Complex data is carried as native JAX complex dtypes (`complex64` by
  default; `complex128` on CPU for oracle/parity runs). The split-plane
  path additionally uses a split re/im structure-of-arrays layout
  (`SplitComplex`) — the same layout the reference's SIMD track chose
  (simd_fft.c:92-109).
- All shape/size analysis happens at trace time on Python ints; nothing
  here introduces dynamic shapes under `jit`.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Direction(enum.IntEnum):
    """Transform direction. Values match the reference convention
    (fft_common.h:31-34): FORWARD = -1, INVERSE = +1; the twiddle basis is
    exp(2*pi*i*direction*k/n)."""

    FORWARD = -1
    INVERSE = 1


FORWARD = Direction.FORWARD
INVERSE = Direction.INVERSE


class SplitComplex(NamedTuple):
    """Structure-of-arrays complex: two real arrays of identical shape.

    This is the layout of the split-plane path (algos/split_stockham.py).
    """

    re: jnp.ndarray
    im: jnp.ndarray

    @staticmethod
    def from_complex(x) -> "SplitComplex":
        return SplitComplex(jnp.real(x), jnp.imag(x))

    def to_complex(self) -> jnp.ndarray:
        return jax_lax_complex(self.re, self.im)


def jax_lax_complex(re, im):
    import jax.lax

    return jax.lax.complex(re, im)


# ---------------------------------------------------------------------------
# Integer helpers (reference: fft_common.h:37-77)
# ---------------------------------------------------------------------------


def is_power_of_two(n: int) -> bool:
    """True if n is a positive power of two (fft_common.h:37-38)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (fft_common.h:41-49)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def log2_int(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two (fft_common.h:52-56)."""
    if not is_power_of_two(n):
        raise ValueError(f"log2_int requires a power of two, got {n}")
    return n.bit_length() - 1


def is_power_of(n: int, base: int) -> bool:
    """True if n is a positive power of `base` (used for radix-4 gating)."""
    if n <= 0:
        return False
    while n % base == 0:
        n //= base
    return n == 1


def complex_dtype_for(dtype) -> np.dtype:
    """Complex dtype matching a real/complex input dtype."""
    d = np.dtype(dtype)
    if d.kind == "c":
        return d
    if d == np.float64:
        return np.dtype(np.complex128)
    return np.dtype(np.complex64)


def real_dtype_for(dtype) -> np.dtype:
    """Real dtype matching a complex/real input dtype."""
    d = np.dtype(dtype)
    if d == np.complex128:
        return np.dtype(np.float64)
    if d == np.complex64:
        return np.dtype(np.float32)
    return d


def as_complex_array(x):
    """Promote a real array to its matching complex dtype; pass complex through."""
    x = jnp.asarray(x)
    if np.dtype(x.dtype).kind != "c":
        x = x.astype(complex_dtype_for(x.dtype))
    return x


def transform_size(x, axis: int = -1) -> int:
    """Static transform length along `axis` (shapes are static under jit)."""
    return int(x.shape[axis])
