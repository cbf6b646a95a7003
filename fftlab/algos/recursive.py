"""Educational recursive (out-of-place) radix-2 FFT.

The analog of reference algorithms/core/recursive_fft.c:16-62 —
the textbook even/odd divide-and-conquer, kept for pedagogy and as an
independent implementation in the correctness matrix. The recursion
unrolls at trace time (n is static); `print_recursion_tree` mirrors the
reference's recursion-tree visualizer (recursive_fft.c:74-91).

Not a performance path — use algos/stockham.py for speed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.types import Direction, FORWARD, is_power_of_two


def _rec(x, n: int, direction: Direction):
    if n == 1:
        return x
    e = _rec(x[..., 0::2], n // 2, direction)
    o = _rec(x[..., 1::2], n // 2, direction)
    k = np.arange(n // 2, dtype=np.float64)
    w = np.exp(2j * np.pi * float(int(direction)) * k / n)
    t = o * const(w, x)
    return jnp.concatenate([e + t, e - t], axis=-1)


def recursive_fft(x, direction=FORWARD):
    """Out-of-place divide-and-conquer FFT (educational; O(n) traced nodes,
    so intended for n up to a few thousand)."""
    x, n, direction = prepare(x, direction)
    if not is_power_of_two(n):
        raise ValueError(f"recursive FFT requires power-of-two size, got n={n}")
    y = _rec(x, n, direction)
    return inverse_scale(y, n, direction)


def print_recursion_tree(n: int, indent: int = 0) -> None:
    """Host-side visualization of the recursion (recursive_fft.c:74-91)."""
    print("  " * indent + f"fft(n={n})")
    if n > 1:
        print_recursion_tree(n // 2, indent + 1)
        print_recursion_tree(n // 2, indent + 1)


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("recursive_fft", recursive_fft)
