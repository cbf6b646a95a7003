"""FFT algorithm families.

Every transform has the uniform batch-first signature
``fn(x, direction=FORWARD) -> [..., n]`` over the last axis, the analog
of the reference's uniform C signature
``void algo(complex_t* x, int n, fft_direction dir)`` (fft_algorithms.h:12-38).

Scaling convention (matches the reference): forward unscaled, inverse 1/n.

`REGISTRY` mirrors the reference test table's capability flags
(tests/test_all.c:50-59) so tests/benchmarks are generic over algorithms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from fftlab.core.types import is_power_of, is_power_of_two


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    name: str
    fn: Callable  # fn(x, direction=FORWARD)
    supports: Callable[[int], bool]  # size predicate
    description: str = ""


def _any_size(n: int) -> bool:
    return n >= 1


def _pow2(n: int) -> bool:
    return is_power_of_two(n)


def _pow4(n: int) -> bool:
    return is_power_of(n, 4)


def build_registry() -> dict:
    # Imported lazily to avoid import cycles.
    from fftlab.algos import bluestein, dft, mixed_radix, radix2, radix4
    from fftlab.algos import iterative, recursive, split_radix, stockham

    specs = [
        AlgoSpec("naive_dft", dft.naive_dft, _any_size, "O(n^2) oracle (matmul)"),
        AlgoSpec("optimized_dft", dft.optimized_dft, _any_size, "cached-twiddle DFT"),
        AlgoSpec("radix2_dit", radix2.radix2_dit, _pow2, "iterative Cooley-Tukey DIT"),
        AlgoSpec("radix2_dif", radix2.radix2_dif, _pow2, "decimation in frequency"),
        AlgoSpec("radix4", radix4.radix4_fft, _pow4, "genuine radix-4 butterflies"),
        AlgoSpec("split_radix", split_radix.split_radix_fft, _pow2, "genuine split-radix"),
        AlgoSpec("bluestein", bluestein.bluestein_fft, _any_size, "chirp-z, arbitrary n"),
        AlgoSpec("mixed_radix", mixed_radix.mixed_radix_fft, _any_size, "general factorization"),
        AlgoSpec("recursive", recursive.recursive_fft, _pow2, "educational divide&conquer"),
        AlgoSpec("iterative", iterative.iterative_fft, _pow2, "annotated pedagogical DIT"),
        AlgoSpec("stockham_mxu", stockham.stockham_fft, stockham.supports, "flagship matmul mixed-radix"),
    ]
    from fftlab.dist.four_step import four_step_fft

    def _composite(n: int) -> bool:
        # Needs a nontrivial n = n1*n2 split (any non-prime n > 3).
        from fftlab.algos.mixed_radix import is_prime

        return n >= 4 and not is_prime(n)

    specs.append(AlgoSpec(
        "four_step", four_step_fft, _composite,
        "two-level n1 x n2 decomposition (parallel_fft.c:213-272)",
    ))
    return {s.name: s for s in specs}
