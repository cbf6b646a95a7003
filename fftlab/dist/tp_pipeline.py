"""Gather-free TP spectral pipeline: four-step FFT -> H -> inverse, all
stages sharded, ZERO replication gathers between them.

`four_step_fft_sharded(..., flatten=True)` ends with a gather to
replicated because the flat [..., n] spectrum interleaves shards. But a
spectral FILTER never needs the flat view: the pointwise multiply is
order-agnostic. This module composes the whole sandwich (SURVEY.md §3.4)
in the sharded matrix domain:

    x.reshape(n2, n1)  [sharded over j1]
      --four-step-->   Y[k1, k2]      [sharded over k2]   (all_to_all)
      --H2 multiply--> Y * H.reshape(n1, n2)  [same sharding, no comm]
      --four-step-->   y.reshape(n2, n1) [sharded over j1] (all_to_all)

The inverse reuses the SAME four-step body with the factor roles
swapped: interpreting Y[k1, k2] as the input matrix B'[j2', j1'] of an
(n1', n2') = (n2, n1) four-step gives B' flat = X in natural order, and
its output lands exactly on x.reshape(n2, n1) — so the pipeline's input
and output shardings are IDENTICAL (P(..., None, axis)) and chained
filters compose without any re-sharding. Total comms: two all_to_alls
over the mesh axis, nothing else. (Reference anchor: parallel_fft.c:248-255
fuses the twiddle into downstream work; this is the multi-device version of
that idea applied to the whole filter sandwich.)

Split re/im planes throughout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fftlab.algos.split_stockham import stockham_fft_split_unscaled
from fftlab.core.types import Direction, FORWARD
from fftlab.dist.four_step import split_n
from fftlab.dist.four_step_split import _twiddle_cs

from jax import shard_map


def _four_step_matrix_local(br, bi, *, rows: int, cols: int, n: int,
                            direction: Direction, axis_name: str, p: int,
                            bnd: int):
    """One four-step pass on the local block of a [..., rows, cols]
    matrix sharded over cols: B[j2, j1] -> Y[k1, k2] (unscaled), output
    sharded over k2 (its last axis). rows = n2, cols = n1."""
    n1, n2 = cols, rows
    n1_local = n1 // p
    idx = jax.lax.axis_index(axis_name)
    cr, ci = stockham_fft_split_unscaled(
        jnp.swapaxes(br, -1, -2), jnp.swapaxes(bi, -1, -2), direction
    )  # [..., n1/p, n2] = C[j1_local, k2]
    tc, ts = _twiddle_cs(n1_local, n2, n, idx * n1_local, direction,
                         br.dtype)
    tc = jnp.swapaxes(tc, -1, -2)
    ts = jnp.swapaxes(ts, -1, -2)
    yr = cr * tc - ci * ts
    yi = cr * ts + ci * tc
    yr = jax.lax.all_to_all(yr, axis_name, split_axis=bnd + 1,
                            concat_axis=bnd, tiled=True)
    yi = jax.lax.all_to_all(yi, axis_name, split_axis=bnd + 1,
                            concat_axis=bnd, tiled=True)
    dr, di = stockham_fft_split_unscaled(
        jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2), direction
    )  # [..., n2/p, n1] = D[k2_local, k1]
    return jnp.swapaxes(dr, -1, -2), jnp.swapaxes(di, -1, -2)


@functools.partial(
    jax.jit, static_argnames=("n1", "axis_name", "mesh", "direction")
)
def _tp_filter_impl(xr, xi, h2r, h2i, *, n1: int, axis_name: str,
                    mesh: Mesh, direction: Direction):
    n = int(xr.shape[-1])
    n2 = n // n1
    p = mesh.shape[axis_name]
    batch = xr.shape[:-1]
    bnd = len(batch)
    inv = Direction(-int(direction))

    def local(br, bi, hr, hi):
        # forward: B[j2, j1] -> Y[k1, k2] (local shard of k2)
        yr, yi = _four_step_matrix_local(
            br, bi, rows=n2, cols=n1, n=n, direction=direction,
            axis_name=axis_name, p=p, bnd=bnd,
        )
        # pointwise H in the matrix domain — same sharding, no comm
        gr = yr * hr - yi * hi
        gi = yr * hi + yi * hr
        # inverse: same body, factor roles swapped (rows=n1, cols=n2):
        # input Y[k1, k2] == B'[j2', j1'] of the (n2, n1) four-step
        zr, zi = _four_step_matrix_local(
            gr, gi, rows=n1, cols=n2, n=n, direction=inv,
            axis_name=axis_name, p=p, bnd=bnd,
        )
        s = jnp.asarray(1.0 / n, dtype=zr.dtype)
        return zr * s, zi * s

    spec = P(*([None] * bnd), None, axis_name)
    hspec = P(None, axis_name)
    xr2 = xr.reshape(*batch, n2, n1)
    xi2 = xi.reshape(*batch, n2, n1)
    return shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, hspec, hspec),
        out_specs=(spec, spec),
    )(xr2, xi2, h2r, h2i)


def tp_spectral_filter_split(xr, xi, hr, hi, mesh: Mesh,
                             axis_name: str = "tp",
                             n1: int | None = None,
                             flatten: bool = False):
    """FFT -> H -> IFFT on one huge signal, TP-sharded end to end.

    xr, xi: [..., n] split planes. hr, hi: the length-n frequency
    response H[k] (natural bin order; rearranged to the four-step matrix
    layout H2[k1, k2] = H[k2 + n2*k1] at trace time). Returns the
    filtered signal as the [..., n2, n1] matrix pair still sharded over
    j1 (`flatten=False`, the gather-free form whose sharding equals the
    INPUT spec — chain more stages freely), or gathered flat [..., n]
    with `flatten=True` (one gather, at the very end only).

    Equivalent numerics: ifft(fft(x) * H), 1/n inverse scaling
    (spectral_filter_split semantics, algos/split_stockham.py).
    """
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    n = int(xr.shape[-1])
    n1_, n2_ = split_n(n, n1)
    p = mesh.shape[axis_name]
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1_} and n2={n2_}"
        )
    # H2[k1, k2] = H[k2 + n2*k1] — exactly H.reshape(n1, n2).
    h2r = jnp.asarray(hr, dtype=xr.dtype).reshape(n1_, n2_)
    h2i = jnp.asarray(hi, dtype=xr.dtype).reshape(n1_, n2_)
    yr, yi = _tp_filter_impl(
        xr, xi, h2r, h2i, n1=n1_, axis_name=axis_name, mesh=mesh,
        direction=FORWARD,
    )
    if flatten:
        yr = jax.device_put(yr, NamedSharding(mesh, P()))
        yi = jax.device_put(yi, NamedSharding(mesh, P()))
        return (yr.reshape(*xr.shape[:-1], n),
                yi.reshape(*xr.shape[:-1], n))
    return yr, yi
