"""Small-N DFT codelets for the mixed-radix path.

The analog of the reference's hand-coded strided DFT-2/3/5 kernels
(mixed_radix.c:67-104) and the general prime-factor DFT (mixed_radix.c:107-124).

Each codelet transforms axis -2 of a `[..., p, m]` tensor (p = radix,
m = stride count), vectorized over everything else — one elementwise pass
of the explicit minimal-operation formula, or one matmul for general p.
Direction enters through `s = i*direction` (the reference's `dir` sign).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.algos._common import const
from fftlab.core.twiddle import dft_matrix_np
from fftlab.core.types import Direction


def dft2(x, direction):
    """2-point butterfly (mixed_radix.c:67-73): [a+b, a-b]."""
    a = x[..., 0, :]
    b = x[..., 1, :]
    return jnp.stack([a + b, a - b], axis=-2)


def dft3(x, direction):
    """3-point DFT via the real/imag split form (mixed_radix.c:76-87).

    With u = x1+x2, v = x1-x2:
      X0 = x0 + u
      X1 = x0 - u/2 + i*dir*sin(2*pi/3)*v
      X2 = x0 - u/2 - i*dir*sin(2*pi/3)*v
    """
    s = 1j * float(int(direction)) * np.sin(2 * np.pi / 3)
    x0, x1, x2 = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    u = x1 + x2
    v = x1 - x2
    w = x0 - 0.5 * u
    sv = jnp.asarray(np.complex128(s)).astype(x.dtype) * v
    return jnp.stack([x0 + u, w + sv, w - sv], axis=-2)


def dft5(x, direction):
    """5-point Winograd-style DFT (mixed_radix.c:90-104 capability).

    Uses the classic 5-point factorization with constants
    c1 = cos(2*pi/5), c2 = cos(4*pi/5), s1 = sin(2*pi/5), s2 = sin(4*pi/5).
    """
    d = float(int(direction))
    c1, c2 = np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5)
    s1, s2 = np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5)
    x0 = x[..., 0, :]
    x1, x2, x3, x4 = x[..., 1, :], x[..., 2, :], x[..., 3, :], x[..., 4, :]
    t1 = x1 + x4
    t2 = x2 + x3
    t3 = x1 - x4
    t4 = x2 - x3
    cd = lambda v: jnp.asarray(np.complex128(v)).astype(x.dtype)  # noqa: E731
    m1 = x0 + cd(c1) * t1 + cd(c2) * t2
    m2 = x0 + cd(c2) * t1 + cd(c1) * t2
    n1 = cd(1j * d * s1) * t3 + cd(1j * d * s2) * t4
    n2 = cd(1j * d * s2) * t3 - cd(1j * d * s1) * t4
    return jnp.stack([x0 + t1 + t2, m1 + n1, m2 + n2, m2 - n2, m1 - n1], axis=-2)


def dft_general(x, p: int, direction):
    """General radix-p DFT over axis -2 as one matmul against the p x p
    DFT matrix (mixed_radix.c:107-124, but one contraction instead of
    O(p^2) scalar loops)."""
    F = const(dft_matrix_np(p, Direction(int(direction))), x)
    return jnp.einsum("ap,...pm->...am", F, x,
                      precision=jax.lax.Precision.HIGHEST)


def apply_codelet(x, p: int, direction):
    """Dispatch: explicit minimal-op codelet for p in {2,3,5}, matmul
    otherwise. x: [..., p, m]."""
    if p == 2:
        return dft2(x, direction)
    if p == 3:
        return dft3(x, direction)
    if p == 5:
        return dft5(x, direction)
    return dft_general(x, p, direction)
