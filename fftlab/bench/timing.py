"""Device timing for the planner's MEASURE mode: the slope protocol.

`slope_time` times a short and a long run of back-to-back calls, each
fenced with `jax.block_until_ready`, and returns the per-call slope
between them, which cancels the fixed dispatch and synchronisation cost.
Inputs differ on every call, so no call can reuse another's result.

Every MEASURE consumer (plan/planner.py, plan/split_tuning.py) shares
this implementation; wisdom entries it produces carry
``protocol: "slope"``.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

PROTOCOL = "slope"


def slope_time(fn: Callable, make_args: Callable[[int], Sequence],
               iters: int = 6, repeats: int = 3) -> float:
    """Median per-call seconds of ``fn(*make_args(i))``.

    make_args(i) must return a DIFFERENT argument tuple for every
    distinct i (vary the data, not the shapes — shape changes
    recompile)."""
    import jax

    iters = max(int(iters), 2)
    ctr = [0]

    def fresh(k: int) -> list:
        out = []
        for _ in range(k):
            out.append(tuple(make_args(ctr[0])))
            ctr[0] += 1
        return out

    jax.block_until_ready(fn(*fresh(1)[0]))  # compile + warm

    def run(k: int) -> float:
        variants = fresh(k)
        jax.block_until_ready(variants)
        t0 = time.perf_counter()
        outs = [fn(*v) for v in variants]
        jax.block_until_ready(outs)
        return time.perf_counter() - t0

    k1, k2 = max(iters // 3, 1), iters
    slopes = [(run(k2) - run(k1)) / (k2 - k1) for _ in range(repeats)]
    return float(np.median(slopes))
