"""Sharded 2D FFT: rows distributed, one all_to_all between the two
1D passes (the pencil-decomposition pattern of distributed FFT
libraries; the reference's 2D transform, image_fft.c:35-72, is the
single-core row-column ancestor).

Split re/im planes throughout (complex-free). Layout:

    x [R, C] sharded on rows
      FFT along C (local, every row complete)
      all_to_all: reshard rows -> cols
      FFT along R (local, every column complete)
      (optionally all_to_all back so the output is row-sharded again)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.split_stockham import stockham_fft_split_unscaled
from fftlab.core.types import Direction, FORWARD

from jax import shard_map


@functools.partial(
    jax.jit,
    static_argnames=("direction", "axis_name", "mesh", "transposed_out",
                     "chunks"),
)
def _impl(xr, xi, *, direction: Direction, axis_name: str, mesh: Mesh,
          transposed_out: bool, chunks: int = 1):
    R, C = int(xr.shape[-2]), int(xr.shape[-1])
    p = mesh.shape[axis_name]

    def _row_stage(br, bi):
        """Row FFTs + the exposing all_to_all on a slab of local rows."""
        cr, ci = stockham_fft_split_unscaled(br, bi, direction)
        cr = jax.lax.all_to_all(cr, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        ci = jax.lax.all_to_all(ci, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        return cr, ci  # [rows*p, C/p]

    def local(br, bi):
        if chunks == 1:
            # [R/p, C]: FFT along C, then expose rows: -> [R, C/p].
            cr, ci = _row_stage(br, bi)
        else:
            # Comm/compute overlap (same pipelining as
            # dist.four_step_split chunks): the row stage is independent
            # per local-row slab, so K unrolled chunks give K
            # all_to_alls each overlappable with the next chunk's FFTs;
            # the column FFT below needs every row and stays a barrier.
            rloc = R // p
            rows = rloc // chunks
            parts = [_row_stage(br[c * rows:(c + 1) * rows, :],
                                bi[c * rows:(c + 1) * rows, :])
                     for c in range(chunks)]

            # Chunk c delivers global rows d*rloc + c*rows + r ordered
            # (d, r); restack (c, d, r) -> (d, c, r).
            def reorder(arrs):
                a = jnp.stack(arrs, axis=0)  # [K, rows*p, C/p]
                a = a.reshape(chunks, p, rows, a.shape[-1])
                a = jnp.moveaxis(a, 1, 0)
                return a.reshape(R, a.shape[-1])

            cr = reorder([x for x, _ in parts])
            ci = reorder([x for _, x in parts])
        # FFT along R: transpose so R is the last axis.
        dr, di = stockham_fft_split_unscaled(
            jnp.swapaxes(cr, -1, -2), jnp.swapaxes(ci, -1, -2), direction
        )  # [C/p, R]
        if transposed_out:
            return dr, di
        # Restore [R/p, C]: swap back then reshard cols -> rows.
        dr = jnp.swapaxes(dr, -1, -2)
        di = jnp.swapaxes(di, -1, -2)
        dr = jax.lax.all_to_all(dr, axis_name, split_axis=0, concat_axis=1,
                                tiled=True)
        di = jax.lax.all_to_all(di, axis_name, split_axis=0, concat_axis=1,
                                tiled=True)
        return dr, di

    spec_in = P(axis_name, None)
    spec_out = P(axis_name, None)
    yr, yi = shard_map(
        local, mesh=mesh, in_specs=(spec_in, spec_in),
        out_specs=(spec_out, spec_out),
    )(xr, xi)
    if direction == Direction.INVERSE:
        s = jnp.asarray(1.0 / (R * C), dtype=yr.dtype)
        yr, yi = yr * s, yi * s
    return yr, yi


def fft2_sharded_split(xr, xi, mesh: Mesh, axis_name: str = "tp",
                       direction=FORWARD, transposed_out: bool = False,
                       chunks: int = 1):
    """2D FFT of [R, C] split planes with rows sharded over
    `mesh[axis_name]`.

    `transposed_out=True` skips the restoring all_to_all and returns
    the spectrum TRANSPOSED ([C, R], column-sharded) — half the
    communication when the consumer is orientation-agnostic (pointwise
    filters, magnitude spectra).
    `chunks=K` pipelines the row stage (K all_to_alls overlappable with
    compute — see dist.four_step_split); K must divide R/p.
    Requires the axis size to divide both R and C.
    """
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    R, C = int(xr.shape[-2]), int(xr.shape[-1])
    p = mesh.shape[axis_name]
    if R % p or C % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide rows={R} and cols={C}"
        )
    chunks = int(chunks)
    if chunks < 1 or (R // p) % chunks:
        raise ValueError(f"chunks={chunks} must divide R/p = {R // p}")
    return _impl(xr, xi, direction=Direction(int(direction)),
                 axis_name=axis_name, mesh=mesh,
                 transposed_out=bool(transposed_out), chunks=chunks)
