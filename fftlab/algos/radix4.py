"""Genuine radix-4 DIT FFT.

The reference exposes a radix-4 API but executes plain radix-2 butterflies
"for reliability" (radix4.c:108-125; docs/api-reference.md). This module
implements the real thing: base-4 digit-reversal permutation, then
log4(n) stages of true 4-point butterflies — the 4x4 DFT matrix
[1 1 1 1; 1 -j -1 j; 1 -1 1 -1; 1 j -1 -j] the reference only demos
(radix4.c:50-66) is here the per-stage matmul contraction.

Radix-4 does ~25% fewer multiplies than radix-2 (radix4.c:191-212); on an
accelerator the win is fewer stages -> fewer whole-array passes (memory
traffic), which is what actually matters on a bandwidth-bound transform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fftlab.algos._common import const, inverse_scale, prepare
from fftlab.core.bitrev import digit_reverse_indices
from fftlab.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab.core.types import FORWARD, is_power_of


def radix4_fft(x, direction=FORWARD):
    """In-order radix-4 DIT: digit-reverse gather, then stages of 4-point
    butterflies with per-stage twiddles. Requires n = 4^k."""
    x, n, direction = prepare(x, direction)
    if not is_power_of(n, 4):
        raise ValueError(f"radix-4 FFT requires n = 4^k, got n={n}")
    if n == 1:
        return x
    batch = x.shape[:-1]

    x = jnp.take(x, jnp.asarray(digit_reverse_indices(n, 4)), axis=-1)
    F4 = dft_matrix_np(4, direction)
    m = 1
    while m < n:
        m *= 4
        q = m // 4
        # Blocks of m; each block holds 4 quarter-transforms of length q.
        x = x.reshape(*batch, n // m, 4, q)
        # Twiddle W_m^{p*j} applied to quarter p, position j (DIT twiddles).
        tw = const(stage_twiddle_np(4, q, direction), x)  # [4, q]
        t = x * tw
        # True 4-point butterfly across the quarter axis (one contraction).
        x = jnp.einsum("ap,...pj->...aj", const(F4, x), t,
                       precision=jax.lax.Precision.HIGHEST)
    x = x.reshape(*batch, n)
    return inverse_scale(x, n, direction)


if __name__ == "__main__":
    from fftlab.algos._common import run_module_demo

    run_module_demo("radix4_fft", radix4_fft)
