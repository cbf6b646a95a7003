"""Sharded overlap-save filtering on split re/im planes (complex-free).

The split-plane variant of dist/overlap_save.py. The split signal
pair doubles as a two-for-one channel packer: a REAL frequency response
is Hermitian, so filtering commutes with Re/Im extraction — pack two
real channels as (xr, xi) and both come out filtered independently
(dsp/filtering.fft_filter_split documents the same trick on one device).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.split_stockham import (
    _twiddle_split,
    stockham_fft_split_unscaled,
)
from fftlab.core.types import Direction, next_power_of_two

from jax import shard_map


def _local_os_split(xr, xi, Hr, Hi, chunk: int, nh: int, fft_size: int):
    from fftlab.core.framing import frame_signal_strided

    hop = fft_size - (nh - 1)
    n_blocks = -(-chunk // hop)
    fr = frame_signal_strided(xr, fft_size, hop, n_blocks)
    fi = frame_signal_strided(xi, fft_size, hop, n_blocks)
    Fr, Fi = stockham_fft_split_unscaled(fr, fi, Direction.FORWARD)
    Gr, Gi = _twiddle_split(Fr, Fi, Hr, Hi)
    yr, yi = stockham_fft_split_unscaled(Gr, Gi, Direction.INVERSE)
    s = 1.0 / fft_size
    yr = (yr * s)[..., nh - 1:]
    yi = (yi * s)[..., nh - 1:]
    shape = (*yr.shape[:-2], n_blocks * hop)
    return (yr.reshape(shape)[..., :chunk],
            yi.reshape(shape)[..., :chunk])


@functools.partial(
    jax.jit, static_argnames=("nh", "fft_size", "axis_name", "mesh")
)
def _impl(xr, xi, h, *, nh: int, fft_size: int, axis_name: str,
          mesh: Mesh):
    p = mesh.shape[axis_name]
    n = int(xr.shape[-1])
    chunk = n // p
    bnd = xr.ndim - 1

    def local(cr, ci, hrep):
        hp = jnp.pad(hrep, [(0, fft_size - nh)])
        Hr, Hi = stockham_fft_split_unscaled(
            hp, jnp.zeros_like(hp), Direction.FORWARD
        )
        if nh > 1:
            perm = [(i, i + 1) for i in range(p - 1)]
            har = jax.lax.ppermute(cr[..., chunk - (nh - 1):], axis_name,
                                   perm=perm)
            hai = jax.lax.ppermute(ci[..., chunk - (nh - 1):], axis_name,
                                   perm=perm)
            cr = jnp.concatenate([har, cr], axis=-1)
            ci = jnp.concatenate([hai, ci], axis=-1)
        return _local_os_split(cr, ci, Hr, Hi, chunk, nh, fft_size)

    spec = P(*([None] * bnd), axis_name)
    return shard_map(
        local, mesh=mesh, in_specs=(spec, spec, P()),
        out_specs=(spec, spec),
    )(xr, xi, h)


def overlap_save_filter_sharded_split(xr, xi, h, mesh: Mesh,
                                      axis_name: str = "sp",
                                      fft_size: int | None = None):
    """Causal FIR filtering of a split-complex signal pair, time-sharded
    with ppermute halo — no complex dtype anywhere.

    xr, xi: [..., n] float planes (or two REAL channels packed as a
    pair — h's real response is Hermitian, so each plane is filtered
    independently). h: [nh] real taps. Matches
    fft_convolution(x, h)[..., :n] on each plane.
    """
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    h = jnp.asarray(h, dtype=xr.dtype)
    n, nh = int(xr.shape[-1]), int(h.shape[-1])
    p = mesh.shape[axis_name]
    if n % p:
        raise ValueError(f"n={n} not divisible by {axis_name}={p}")
    if n // p < nh - 1:
        raise ValueError(
            f"chunk {n // p} shorter than filter halo {nh - 1}"
        )
    if fft_size is None:
        fft_size = max(next_power_of_two(4 * nh), 256)
    return _impl(xr, xi, h, nh=nh, fft_size=fft_size,
                 axis_name=axis_name, mesh=mesh)


def overlap_save_filterbank_sharded_split(x, h_bank, mesh: Mesh,
                                          channel_axis: str = "dp",
                                          time_axis: str = "sp",
                                          fft_size: int | None = None):
    """Complex-free multi-channel filterbank: real channels sharded over
    `channel_axis`, time over `time_axis` (the BASELINE config-5
    pipeline on split planes). Channel PAIRS within each shard ride the
    re/im planes of one transform when they share taps; here each
    channel keeps its own taps, so planes carry (channel, zero).

    x: [channels, n] real; h_bank: [channels, nh] real.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    h_bank = jnp.asarray(h_bank, dtype=jnp.float32)
    c, n = int(x.shape[-2]), int(x.shape[-1])
    nh = int(h_bank.shape[-1])
    pc = mesh.shape[channel_axis]
    pt = mesh.shape[time_axis]
    if c % pc or n % pt:
        raise ValueError(f"shape ({c},{n}) not divisible by mesh ({pc},{pt})")
    if n // pt < nh - 1:
        raise ValueError(f"chunk {n // pt} shorter than halo {nh - 1}")
    if fft_size is None:
        fft_size = max(next_power_of_two(4 * nh), 256)
    chunk = n // pt

    def local(xl, hl):
        # xl: [c/pc, n/pt]; hl: [c/pc, nh]
        hp = jnp.pad(hl, [(0, 0), (0, fft_size - nh)])
        Hr, Hi = stockham_fft_split_unscaled(
            hp, jnp.zeros_like(hp), Direction.FORWARD
        )
        Hr = Hr[:, None, :]  # broadcast over blocks
        Hi = Hi[:, None, :]
        if nh > 1:
            halo = jax.lax.ppermute(
                xl[..., chunk - (nh - 1):], time_axis,
                perm=[(i, i + 1) for i in range(pt - 1)],
            )
            xp = jnp.concatenate([halo, xl], axis=-1)
        else:
            xp = xl
        yr, _ = _local_os_split(xp, jnp.zeros_like(xp), Hr, Hi,
                                chunk, nh, fft_size)
        return yr

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(channel_axis, time_axis), P(channel_axis, None)),
        out_specs=P(channel_axis, time_axis),
    )
    return jax.jit(fn)(x, h_bank)
