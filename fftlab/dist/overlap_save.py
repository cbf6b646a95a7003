"""Sharded streaming FIR filtering: overlap-save with time-blocks sharded
across devices and a ``ppermute`` halo exchange.

A re-design of the reference's streaming block processing
(realtime_analyzer.c:58-93 hop loop; convolution.c:284-290 overlap-add
description): the signal's time axis is split into contiguous chunks, one
per device; each device needs the (L-1) samples preceding its chunk to
compute valid outputs — the halo — which its left neighbor sends with one
`ppermute` (the ring/neighbor-exchange pattern, SURVEY.md §2.2
"SP/CP/ring"). Device 0's halo is zeros (causal linear filtering).

After the halo exchange each device runs an ordinary batched overlap-save
(dsp/convolution.py semantics) on its chunk: all blocks are formed by one
gather and filtered as one batch of FFT -> H -> IFFT sandwiches.

The sharded output is bit-identical in exact arithmetic to the unsharded
filter (property test: sharded == single-device == direct convolution).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.stockham import stockham_fft_unscaled
from fftlab.core.types import (
    Direction,
    complex_dtype_for,
    next_power_of_two,
)

from jax import shard_map


def _cfft_fwd(x):
    return stockham_fft_unscaled(x, Direction.FORWARD)


def _cfft_inv_unscaled(x):
    return stockham_fft_unscaled(x, Direction.INVERSE)


def _local_overlap_save(xp, H, chunk: int, nh: int, fft_size: int):
    """Valid-output overlap-save on a halo-prefixed chunk.

    xp: [..., (nh-1) + chunk (+ right pad)] complex; returns [..., chunk]:
    y[t] = sum_tau h[tau] * x[chunk_start + t - tau].
    """
    from fftlab.core.framing import frame_signal_strided

    hop = fft_size - (nh - 1)
    n_blocks = -(-chunk // hop)
    frames = frame_signal_strided(xp, fft_size, hop, n_blocks)
    y = _cfft_inv_unscaled(_cfft_fwd(frames) * H) * (1.0 / fft_size)
    y = y[..., nh - 1 :]  # discard the aliased head of each block
    return y.reshape(*y.shape[:-2], n_blocks * hop)[..., :chunk]


@functools.partial(
    jax.jit, static_argnames=("nh", "fft_size", "axis_name", "mesh")
)
def _overlap_save_sharded_impl(x, h, *, nh: int, fft_size: int,
                               axis_name: str, mesh: Mesh):
    p = mesh.shape[axis_name]
    n = int(x.shape[-1])
    chunk = n // p
    cdtype = x.dtype
    bnd = x.ndim - 1

    def local(xc, hrep):
        # xc: [..., chunk]; hrep: [nh] (replicated).
        H = _cfft_fwd(
            jnp.pad(hrep, [(0, fft_size - nh)]).astype(cdtype)
        )
        if nh > 1:
            # Left neighbor's tail; device 0 receives zeros (causal start).
            halo = jax.lax.ppermute(
                xc[..., chunk - (nh - 1):], axis_name,
                perm=[(i, i + 1) for i in range(p - 1)],
            )
            xp = jnp.concatenate([halo, xc], axis=-1)
        else:
            xp = xc
        return _local_overlap_save(xp, H, chunk, nh, fft_size)

    spec = P(*([None] * bnd), axis_name)
    return shard_map(
        local, mesh=mesh, in_specs=(spec, P()), out_specs=spec
    )(x, h)


def overlap_save_filter_sharded(x, h, mesh: Mesh, axis_name: str = "sp",
                                fft_size: int | None = None):
    """Causal FIR filter y[t] = sum_tau h[tau]*x[t-tau], t in [0, n), with
    the time axis sharded over `mesh[axis_name]`.

    x: [..., n] with n divisible by the axis size; h: [nh] taps.
    Equals ``fft_convolution(x, h)[..., :n]`` exactly (property-tested).
    """
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    was_real = (
        np.dtype(x.dtype).kind != "c" and np.dtype(h.dtype).kind != "c"
    )
    n, nh = int(x.shape[-1]), int(h.shape[-1])
    p = mesh.shape[axis_name]
    if n % p:
        raise ValueError(f"signal length {n} not divisible by axis {axis_name}={p}")
    if n // p < nh - 1:
        raise ValueError(
            f"chunk {n // p} shorter than filter halo {nh - 1}; use fewer shards"
        )
    if fft_size is None:
        fft_size = max(next_power_of_two(4 * nh), 256)
    if fft_size < next_power_of_two(2 * nh):
        raise ValueError(f"fft_size {fft_size} too small for {nh} taps")
    cdtype = complex_dtype_for(jnp.result_type(x, h))
    # h is cast to the COMPLEX dtype: a real->real astype would silently
    # discard complex taps' imaginary part (filtering by real(h)).
    y = _overlap_save_sharded_impl(
        x.astype(cdtype), h.astype(cdtype),
        nh=nh, fft_size=fft_size, axis_name=axis_name, mesh=mesh,
    )
    return jnp.real(y) if was_real else y


def overlap_save_filterbank_sharded(x, h_bank, mesh: Mesh,
                                    channel_axis: str = "dp",
                                    time_axis: str = "sp",
                                    fft_size: int | None = None):
    """Multi-channel filterbank: channels sharded over `channel_axis` (DP),
    time sharded over `time_axis` (SP) — the flagship multi-device
    pipeline.

    x: [channels, n]; h_bank: [channels, nh] per-channel taps.
    """
    x = jnp.asarray(x)
    h_bank = jnp.asarray(h_bank)
    was_real = (
        np.dtype(x.dtype).kind != "c" and np.dtype(h_bank.dtype).kind != "c"
    )
    c, n = int(x.shape[-2]), int(x.shape[-1])
    nh = int(h_bank.shape[-1])
    pc = mesh.shape[channel_axis]
    pt = mesh.shape[time_axis]
    if c % pc or n % pt:
        raise ValueError(f"shape ({c},{n}) not divisible by mesh ({pc},{pt})")
    if n // pt < nh - 1:
        raise ValueError(
            f"time chunk {n // pt} shorter than filter halo {nh - 1}; "
            f"use fewer time shards"
        )
    if fft_size is None:
        fft_size = max(next_power_of_two(4 * nh), 256)
    if fft_size < next_power_of_two(2 * nh):
        raise ValueError(f"fft_size {fft_size} too small for {nh} taps")
    cdtype = complex_dtype_for(jnp.result_type(x, h_bank))
    xc = x.astype(cdtype)
    hb = h_bank.astype(cdtype)  # complex taps keep their imaginary part
    chunk = n // pt

    def local(xl, hl):
        # xl: [c/pc, n/pt]; hl: [c/pc, nh].
        H = _cfft_fwd(
            jnp.pad(hl, [(0, 0), (0, fft_size - nh)]).astype(cdtype)
        )[:, None, :]  # [c/pc, 1(blocks), fft_size]
        if nh > 1:
            halo = jax.lax.ppermute(
                xl[..., chunk - (nh - 1):], time_axis,
                perm=[(i, i + 1) for i in range(pt - 1)],
            )
            xp = jnp.concatenate([halo, xl], axis=-1)
        else:
            xp = xl
        return _local_overlap_save(xp, H, chunk, nh, fft_size)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(channel_axis, time_axis), P(channel_axis, None)),
        out_specs=P(channel_axis, time_axis),
    )
    y = jax.jit(fn)(xc, hb)
    return jnp.real(y) if was_real else y
