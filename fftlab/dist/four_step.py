"""Four-step FFT: one large transform decomposed as n = n1*n2 and sharded
across devices with an ``all_to_all`` transpose over the mesh axis.

A re-design of the reference's OpenMP four-step FFT
(parallel_fft.c:213-272): column FFTs -> twiddle W_n^{ij} -> row FFTs ->
transpose. There the "transpose into temp" (parallel_fft.c:263-271) moves
data between cores through shared memory; here it is `lax.all_to_all`
moving shards between devices, and the per-thread loop bodies are
full matmul transforms (algos/stockham.py).

Derivation: with j = j1 + n1*j2 and k = k2 + n2*k1,
    X[k2 + n2*k1] = sum_{j1} W_{n1}^{j1 k1} * W_n^{j1 k2}
                    * (sum_{j2} x[j1 + n1*j2] * W_{n2}^{j2 k2})
so on B[j2, j1] = x.reshape(n2, n1):
    1. FFT_{n2} over axis j2            (local: j1 is the sharded axis)
    2. multiply by W_n^{j1*k2}          (local; per-shard twiddle slice)
    3. re-shard j1-sharded -> k2-sharded (all_to_all = the transpose)
    4. FFT_{n1} over axis j1            (local: k2 is now the sharded axis)
    5. output matrix Y[k1, k2] = result^T; X = Y.reshape(n)

Sharding requirement: the mesh axis size must divide both n1 and n2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fftlab.algos._common import inverse_scale, prepare
from fftlab.algos.stockham import stockham_fft_unscaled
from fftlab.core.types import (
    Direction,
    FORWARD,
    is_power_of_two,
    log2_int,
    real_dtype_for,
)

from jax import shard_map


def split_n(n: int, n1: int | None = None) -> tuple[int, int]:
    """Pick the n = n1*n2 factorization (n1 ~ sqrt(n), both powers of two
    for pow2 n — parallel_fft.c:220-222 semantics)."""
    if n1 is not None:
        if n % n1:
            raise ValueError(f"n1={n1} does not divide n={n}")
        return n1, n // n1
    if is_power_of_two(n):
        e = log2_int(n)
        n1 = 1 << (e // 2)
        return n1, n // n1
    # General composite: largest divisor <= sqrt(n).
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best, n // best


def _stage_twiddle_device(n1_local: int, n2: int, n: int, j1_offset,
                          direction: Direction, cdtype):
    """W_n^{j1*k2} for the local j1 slice, computed on-device.

    j1*k2 < n, so the product is exact in int32 for n < 2^31; the mod-n
    reduction keeps the phase argument small so float32 exp stays accurate.
    """
    j1 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1_local), 1) + j1_offset
    k2 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1_local), 0)
    m = (j1 * k2) % n
    rdtype = real_dtype_for(cdtype)
    ang = m.astype(rdtype) * np.asarray(
        2.0 * np.pi * float(int(direction)) / n, dtype=rdtype
    )
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang))


def four_step_fft(x, direction=FORWARD, n1: int | None = None, cfft=None):
    """Single-device four-step FFT (the local-math reference for the
    sharded version; also a valid standalone algorithm for huge n where
    two sqrt(n) passes beat one deep factorization)."""
    x, n, direction = prepare(x, direction)
    if cfft is None:
        cfft = stockham_fft_unscaled
    n1, n2 = split_n(n, n1)
    if n1 == 1 or n2 == 1:
        return inverse_scale(cfft(x, direction), n, direction)
    batch = x.shape[:-1]
    b = x.reshape(*batch, n2, n1)
    # 1. FFT over j2 (axis -2): transpose so it is the last axis.
    c = cfft(jnp.swapaxes(b, -1, -2), direction)  # [..., n1, n2] = C[j1, k2]
    # 2. twiddle W_n^{j1*k2}.
    tw = _stage_twiddle_device(n1, n2, n, 0, direction, x.dtype)  # (n2, n1)
    c = c * jnp.swapaxes(tw, -1, -2).astype(x.dtype)
    # 3+4. FFT over j1: transpose back so j1 is last.
    d = cfft(jnp.swapaxes(c, -1, -2), direction)  # [..., n2, n1] = D[k2, k1]
    # 5. Y[k1, k2] = D[k2, k1]; X = Y.flatten.
    y = jnp.swapaxes(d, -1, -2).reshape(*batch, n)
    return inverse_scale(y, n, direction)


@functools.partial(
    jax.jit, static_argnames=("direction", "n1", "axis_name", "mesh")
)
def _four_step_sharded_impl(x, *, direction: Direction, n1: int,
                            axis_name: str, mesh: Mesh):
    n = int(x.shape[-1])
    n2 = n // n1
    p = mesh.shape[axis_name]
    batch = x.shape[:-1]
    bnd = len(batch)
    cdtype = x.dtype

    def local(xb):
        # xb: [..., n2, n1/p] — the j1-sharded matrix block.
        n1_local = n1 // p
        idx = jax.lax.axis_index(axis_name)
        # 1. column FFTs over j2 (full length n2, local).
        c = stockham_fft_unscaled(jnp.swapaxes(xb, -1, -2), direction)
        # c: [..., n1/p, n2] = C[j1_local, k2]
        # 2. per-shard twiddle slice.
        tw = _stage_twiddle_device(
            n1_local, n2, n, idx * n1_local, direction, cdtype
        )  # (n2, n1/p)
        c = c * jnp.swapaxes(tw, -1, -2).astype(cdtype)
        # 3. the all_to_all transpose: re-shard from j1 to k2.
        #    global C is [..., n1, n2] sharded on axis -2; after all_to_all
        #    it is sharded on axis -1: local [..., n1, n2/p].
        c = jax.lax.all_to_all(
            c, axis_name, split_axis=bnd + 1, concat_axis=bnd, tiled=True
        )
        # 4. row FFTs over j1 (full length n1, local).
        d = stockham_fft_unscaled(jnp.swapaxes(c, -1, -2), direction)
        # d: [..., n2/p, n1] = D[k2_local, k1]
        # 5. local transpose to Y[k1, k2_local].
        return jnp.swapaxes(d, -1, -2)  # [..., n1, n2/p]

    spec_in = P(*([None] * bnd), None, axis_name)
    spec_out = P(*([None] * bnd), None, axis_name)
    xm = x.reshape(*batch, n2, n1)
    y = shard_map(
        local, mesh=mesh, in_specs=(spec_in,), out_specs=spec_out
    )(xm)
    # y: [..., n1, n2] sharded over k2 — Y[k1, k2]; X[k2 + n2*k1] = flatten.
    return inverse_scale(y, n, direction)


def four_step_fft_sharded(x, mesh: Mesh, axis_name: str = "tp",
                          direction=FORWARD, n1: int | None = None,
                          flatten: bool = True):
    """One large FFT sharded over `mesh[axis_name]` with an all_to_all
    transpose over the mesh axis (TP: SURVEY.md §2.2 four-step row).

    x: [..., n] (replicated or last-axis sharded). Returns the spectrum as
    [..., n] if `flatten` (XLA gathers as needed), else the [..., n1, n2]
    matrix Y[k1, k2] still sharded over k2 — the form to feed directly
    into a subsequent sharded pointwise stage without any gather.
    """
    x, n, direction = prepare(x, direction)
    n1, n2 = split_n(n, n1)
    p = mesh.shape[axis_name]
    if n1 % p or n2 % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1} and n2={n2}"
        )
    y = _four_step_sharded_impl(
        x, direction=direction, n1=n1, axis_name=axis_name, mesh=mesh
    )
    if flatten:
        # The flat [..., n] view interleaves shards (X[k2 + n2*k1]), which
        # no 1D sharding can represent — gather to replicated, then view.
        y = jax.device_put(y, NamedSharding(mesh, P()))
        return y.reshape(*x.shape[:-1], n)
    return y
