"""Four-step sharded FFT on split re/im planes — the variant for callers
that keep real and imaginary parts in separate float32 arrays.

Same math and collectives as dist/four_step.py with every complex value
carried as two real arrays: the all_to_all moves both planes, and the
per-shard twiddle slice is computed on-device as separate cos/sin.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fftlab.algos.split_stockham import stockham_fft_split_unscaled
from fftlab.core.types import Direction, FORWARD
from fftlab.dist.four_step import split_n

from jax import shard_map


def _twiddle_cs(n1_local: int, n2: int, n: int, j1_offset,
                direction: Direction, rdtype):
    """cos/sin of the four-step twiddle W_n^{j1*k2} for the local slice
    (exact int32 mod keeps the phase argument small; j1*k2 < n < 2^31)."""
    j1 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1_local), 1) + j1_offset
    k2 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1_local), 0)
    m = (j1 * k2) % n
    ang = m.astype(rdtype) * np.asarray(
        2.0 * np.pi * float(int(direction)) / n, dtype=rdtype
    )
    return jnp.cos(ang), jnp.sin(ang)


@functools.partial(
    jax.jit,
    static_argnames=("direction", "n1", "axis_name", "mesh", "chunks",
                     "batch_axes"),
)
def _impl(xr, xi, *, direction: Direction, n1: int, axis_name: str,
          mesh: Mesh, chunks: int = 1,
          batch_axes: tuple | None = None):
    n = int(xr.shape[-1])
    n2 = n // n1
    p = mesh.shape[axis_name]
    batch = xr.shape[:-1]
    bnd = len(batch)
    if batch_axes is None:
        batch_axes = (None,) * bnd
    rdtype = xr.dtype

    def _col_stage(xrT, xiT, row_offset, rows):
        """Column FFT + four-step twiddle on a slab of local rows."""
        cr, ci = stockham_fft_split_unscaled(xrT, xiT, direction)
        tc, ts = _twiddle_cs(rows, n2, n, row_offset, direction, rdtype)
        tc = jnp.swapaxes(tc, -1, -2)
        ts = jnp.swapaxes(ts, -1, -2)
        yr = cr * tc - ci * ts
        yi = cr * ts + ci * tc
        yr = jax.lax.all_to_all(yr, axis_name, split_axis=bnd + 1,
                                concat_axis=bnd, tiled=True)
        yi = jax.lax.all_to_all(yi, axis_name, split_axis=bnd + 1,
                                concat_axis=bnd, tiled=True)
        return yr, yi  # [..., rows*p, n2/p]

    def local(br, bi):
        n1_local = n1 // p
        idx = jax.lax.axis_index(axis_name)
        xrT = jnp.swapaxes(br, -1, -2)  # [..., n1/p, n2]
        xiT = jnp.swapaxes(bi, -1, -2)
        if chunks == 1:
            yr, yi = _col_stage(xrT, xiT, idx * n1_local, n1_local)
        else:
            # Comm/compute overlap: the column stage is independent per
            # local-row slab, so K unrolled chunks give the scheduler K
            # all_to_alls each overlappable with the NEXT chunk's column
            # FFT (async collectives on real devices; the four-step
            # transpose of parallel_fft.c:263-271, pipelined). The final
            # row FFT needs every chunk, so it stays a barrier.
            rows = n1_local // chunks
            parts = [
                _col_stage(
                    xrT[..., c * rows:(c + 1) * rows, :],
                    xiT[..., c * rows:(c + 1) * rows, :],
                    idx * n1_local + c * rows, rows,
                )
                for c in range(chunks)
            ]
            # Chunk c's rows are globally j1 = d*n1_local + c*rows + r
            # but arrive ordered (d, r): restack (c, d, r) -> (d, c, r)
            # so the flattened axis is j1-ordered for the row FFT.
            def reorder(arrs):
                a = jnp.stack(arrs, axis=bnd)  # [..., K, rows*p, n2/p]
                shp = a.shape
                a = a.reshape(*shp[:bnd], chunks, p, rows, shp[-1])
                a = jnp.moveaxis(a, bnd + 1, bnd)  # (p, K, rows)
                return a.reshape(*shp[:bnd], n1, shp[-1])

            yr = reorder([pr for pr, _ in parts])
            yi = reorder([pi for _, pi in parts])
        dr, di = stockham_fft_split_unscaled(
            jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2), direction
        )  # [..., n2/p, n1]
        return jnp.swapaxes(dr, -1, -2), jnp.swapaxes(di, -1, -2)

    # Batch dims may themselves be sharded over OTHER mesh axes (the 2D
    # block-sharded transform, dist.fft2_mesh2d, runs its row stage with
    # rows sharded over one axis while this four-step distributes each
    # row's transform over the other).
    spec = P(*batch_axes, None, axis_name)
    xr2 = xr.reshape(*batch, n2, n1)
    xi2 = xi.reshape(*batch, n2, n1)
    yr, yi = shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)
    )(xr2, xi2)
    if direction == Direction.INVERSE:
        s = jnp.asarray(1.0 / n, dtype=yr.dtype)
        yr, yi = yr * s, yi * s
    return yr, yi


def four_step_fft_sharded_split(xr, xi, mesh: Mesh, axis_name: str = "tp",
                                direction=FORWARD, n1: int | None = None,
                                flatten: bool = True, chunks: int = 1,
                                batch_axes: tuple | None = None):
    """Sharded single transform on split planes: [..., n] re/im pair ->
    spectrum pair. Complex-dtype-free end to end (collectives included).

    `flatten=False` returns the [..., n1, n2] matrix pair still sharded
    over k2 for fused downstream pointwise stages.

    `chunks=K` pipelines the column stage: K independent
    column-FFT+twiddle+all_to_all slabs let the scheduler overlap each
    chunk's transfer with the next chunk's compute (at the price of
    one local re-stack before the row FFT). Numerics are identical;
    K must divide n1/p. Default 1 = the single-collective form.

    `batch_axes` optionally names a mesh axis per leading batch dim
    (None entries replicate): the batch stays sharded over those axes
    while each transform distributes over `axis_name` — the
    both-axes-distributed 2D transform (dist.fft2_mesh2d) is built on
    this. Implies flatten=False semantics for the batch dims (the final
    gather in flatten=True only replicates if you ask for it).
    """
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    n1_, n2_ = split_n(n, n1)
    p = mesh.shape[axis_name]
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1_} and n2={n2_}"
        )
    chunks = int(chunks)
    if chunks < 1 or (n1_ // p) % chunks:
        raise ValueError(
            f"chunks={chunks} must be >= 1 and divide n1/p = {n1_ // p}"
        )
    if batch_axes is not None:
        if len(batch_axes) != xr.ndim - 1:
            raise ValueError(
                f"batch_axes {batch_axes} must name one entry per batch "
                f"dim ({xr.ndim - 1})"
            )
        if axis_name in batch_axes:
            raise ValueError(
                f"batch_axes may not reuse the transform axis {axis_name!r}"
            )
        for ax, dim in zip(batch_axes, xr.shape[:-1]):
            if ax is not None and dim % mesh.shape[ax]:
                raise ValueError(
                    f"mesh axis {ax}={mesh.shape[ax]} must divide batch "
                    f"dim {dim}"
                )
        batch_axes = tuple(batch_axes)
    yr, yi = _impl(xr, xi, direction=direction, n1=n1_,
                   axis_name=axis_name, mesh=mesh, chunks=chunks,
                   batch_axes=batch_axes)
    if flatten:
        yr = jax.device_put(yr, NamedSharding(mesh, P()))
        yi = jax.device_put(yi, NamedSharding(mesh, P()))
        return (yr.reshape(*xr.shape[:-1], n),
                yi.reshape(*xr.shape[:-1], n))
    return yr, yi
