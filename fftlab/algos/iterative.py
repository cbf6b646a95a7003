"""Pedagogical iterative FFT with an execution-plan explainer.

The analog of reference algorithms/core/iterative_fft.c:57-175 —
the same MATH as radix-2 DIT, realized through the other compilation
strategy: radix2_dit unrolls log2(n) stages into a fixed reshape/concat
pipeline at trace time; this module keeps the classic IN-PLACE
formulation (fixed [n] layout, index-arithmetic butterflies,
radix2_dit.c:84-112) and rolls the stage loop into ONE compiled
`lax.fori_loop` body with a dynamic stage counter — the
compiler-friendly-control-flow lesson (static shapes, dynamic
indices), where the reference's lesson was cache behavior
(iterative_fft.c:144-175). `explain()` prints the plan; utils/viz.py
draws it.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.bitrev import bit_reverse_indices
from fftlab.core.twiddle import twiddle_np
from fftlab.core.types import FORWARD, is_power_of_two, log2_int


def iterative_fft(x, direction=FORWARD):
    """In-place-formulation radix-2 DIT under a rolled fori_loop.

    Distinct execution plan from algos.radix2.radix2_dit (which unrolls
    stages into reshape/concat passes): here the array keeps ONE fixed
    [..., n] layout for all stages and each stage computes its butterfly
    partners (i XOR m/2) and twiddle exponents (j * n/m) from the loop
    counter — exactly iterative_fft.c's triple loop collapsed to a
    single vectorized body that the compiler traces ONCE for all
    log2(n) stages."""
    x, n, direction = prepare(x, direction)
    if not is_power_of_two(n):
        raise ValueError(
            f"iterative FFT requires power-of-two size, got n={n}")
    if n == 1:
        return x
    log2n = log2_int(n)

    x = jnp.take(x, jnp.asarray(bit_reverse_indices(n)), axis=-1)
    # Full twiddle table W_n^k, k < n/2 (float64-precomputed); every
    # stage's twiddles are a strided view: stage s uses W_n^(j * n/m).
    wn = const(twiddle_np(n, direction)[: max(n // 2, 1)], x)
    i = jnp.arange(n)

    def stage(s, x):
        half = jnp.left_shift(1, s)              # m/2 for m = 2^(s+1)
        j = jnp.bitwise_and(i, half - 1)         # index within half-block
        upper = jnp.bitwise_and(i, half) != 0    # odd-half element?
        partner = jnp.bitwise_xor(i, half)
        # exponent j * (n/m) = j << (log2n - 1 - s), always < n/2
        w = wn[jnp.left_shift(j, log2n - 1 - s)]
        xp = jnp.take(x, partner, axis=-1)
        u = jnp.where(upper, xp, x)              # even-half value
        v = jnp.where(upper, x, xp)              # odd-half value
        t = w * v
        return jnp.where(upper, u - t, u + t)

    x = lax.fori_loop(0, log2n, stage, x)
    return inverse_scale(x, n, direction)


def explain(n: int) -> str:
    """Describe the stage-by-stage execution plan for an n-point transform
    (host-side; analog of iterative_fft.c:101-133's visualizer)."""
    if not is_power_of_two(n):
        raise ValueError("explain() requires a power-of-two size")
    lines = [
        f"iterative radix-2 DIT plan for n={n} (log2(n)={log2_int(n)} stages)",
        f"  step 0: bit-reversal permutation as ONE gather of {n} indices",
        f"          (table: {list(bit_reverse_indices(min(n, 16)))}{'...' if n > 16 else ''})",
    ]
    for s in range(1, log2_int(n) + 1):
        m = 1 << s
        lines.append(
            f"  stage {s}: {n // m} blocks x {m // 2} butterflies, span m={m}; "
            f"one fused VPU pass over [{n // m}, {m}] view, {m // 2} twiddles W_{m}^j"
        )
    lines.append(
        "  on device: ONE lax.fori_loop body serves all stages (partner =\n"
        "  i XOR m/2, twiddle exponent = j*n/m — dynamic indices over a\n"
        "  static [n] layout); XLA fuses the\n"
        "  gather + select + multiply chain into one pass per stage."
    )
    return "\n".join(lines)


if __name__ == "__main__":  # pragma: no cover - demo entry point
    print(explain(16))
