"""Pipeline-parallel (PP) streaming spectral pipeline: the serving
sandwich window -> FFT -> xH -> IFFT as PIPELINE STAGES assigned to mesh
devices, with time blocks as microbatches flowing through `ppermute`
hand-offs.

This is the PP analog SURVEY.md §2.2 names ("stage-pipelined streaming
filterbank"): the reference's only streaming pipeline is one core's hop
loop (realtime_analyzer.c:58-93, window -> FFT -> average in sequence on
one CPU); here each stage runs on its own device, so block t is windowed
on device 0 while block t-1 is transformed on device 1, block t-2 is
multiplied by H on device 2, and block t-3 is inverse-transformed on
device 3 — a GPipe-style schedule over mesh neighbours.

SPMD form: with P pipeline devices and B blocks, the loop runs B + P - 1
ticks. At each tick device d applies its stage group to the block handed
over by device d-1 (device 0 ingests block t from the input), then every
in-flight block moves one hop down the chain via ONE `ppermute`
(neighbour traffic only — the ring pattern). Outputs complete
on device P-1 and are replicated by a masked `psum`. Steady state keeps
all P devices busy; pipeline bubbles are the usual P-1 fill/drain ticks.

Split re/im planes throughout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.split_stockham import stockham_fft_split_unscaled
from fftlab.core.types import Direction

from jax import shard_map

N_STAGES = 4  # window | forward FFT | xH | inverse FFT (+1/n)


@functools.partial(jax.jit, static_argnames=("axis_name", "mesh"))
def _impl(br, bi, wr, hr, hi, *, axis_name: str, mesh: Mesh):
    B, n = int(br.shape[0]), int(br.shape[1])
    p = mesh.shape[axis_name]
    group = N_STAGES // p

    def local(blocks_r, blocks_i, w, hr_, hi_):
        d = jax.lax.axis_index(axis_name)

        # The four stages, each [n] pair -> [n] pair.
        def s_window(ar, ai):
            return ar * w, ai * w

        def s_fft(ar, ai):
            return stockham_fft_split_unscaled(ar, ai, Direction.FORWARD)

        def s_mult(ar, ai):
            return ar * hr_ - ai * hi_, ar * hi_ + ai * hr_

        def s_ifft(ar, ai):
            zr, zi = stockham_fft_split_unscaled(ar, ai, Direction.INVERSE)
            s = jnp.asarray(1.0 / n, dtype=zr.dtype)
            return zr * s, zi * s

        stages = [s_window, s_fft, s_mult, s_ifft]

        def make_group(g):
            def f(ar, ai):
                for fn in stages[g * group:(g + 1) * group]:
                    ar, ai = fn(ar, ai)
                return ar, ai
            return f

        groups = [make_group(g) for g in range(p)]

        def tick(t, carry):
            buf_r, buf_i, out_r, out_i = carry
            # Device 0 ingests block t (zeros past the end — those
            # ticks only drain the pipeline); everyone else processes
            # what the previous device handed over last tick.
            idx = jnp.clip(t, 0, B - 1)
            live = jnp.asarray(t < B, dtype=buf_r.dtype)
            in_r = jnp.where(d == 0, blocks_r[idx] * live, buf_r)
            in_i = jnp.where(d == 0, blocks_i[idx] * live, buf_i)
            yr, yi = jax.lax.switch(d, groups, in_r, in_i)
            # The last device's result is finished block t - (P-1).
            done = t - (p - 1)
            ok = (d == p - 1) & (done >= 0)
            wi = jnp.clip(done, 0, B - 1)
            out_r = out_r.at[wi].set(jnp.where(ok, yr, out_r[wi]))
            out_i = out_i.at[wi].set(jnp.where(ok, yi, out_i[wi]))
            if p > 1:  # hand every in-flight block one hop down the chain
                perm = [(i, i + 1) for i in range(p - 1)]
                buf_r = jax.lax.ppermute(yr, axis_name, perm)
                buf_i = jax.lax.ppermute(yi, axis_name, perm)
            return buf_r, buf_i, out_r, out_i

        # Loop carries depend on axis_index, so they are 'varying' over
        # the pp axis; the initial zeros must be cast to match (the
        # shard_map varying-manual-axes typing rule for scan carries).
        def _vary(x):
            try:
                return jax.lax.pcast(x, (axis_name,), to="varying")
            except (AttributeError, TypeError):  # older jax: no VMA types
                return x

        z = _vary(jnp.zeros((n,), blocks_r.dtype))
        out0 = _vary(jnp.zeros((B, n), blocks_r.dtype))
        _, _, out_r, out_i = jax.lax.fori_loop(
            0, B + p - 1, tick, (z, z, out0, out0)
        )
        # Only device P-1 holds finished blocks; masked psum replicates.
        mask = jnp.asarray(d == p - 1, dtype=out_r.dtype)
        out_r = jax.lax.psum(out_r * mask, axis_name)
        out_i = jax.lax.psum(out_i * mask, axis_name)
        return out_r, out_i

    rep = P(None, None)
    one = P(None)
    return shard_map(
        local, mesh=mesh,
        in_specs=(rep, rep, one, one, one),
        out_specs=(rep, rep),
    )(br, bi, wr, hr, hi)


def pp_spectral_pipeline_split(blocks_r, blocks_i, hr, hi, mesh: Mesh,
                               axis_name: str = "pp", window=None):
    """Filter B time blocks through the 4-stage pipeline over
    `mesh[axis_name]` (P must be 1, 2, or 4 — the stage groups per
    device are contiguous runs of window/FFT/xH/IFFT).

    blocks_r, blocks_i: [B, n] split planes (the caller frames the
    stream; per-block processing is circular — compose with the
    overlap-save framing of dist.overlap_save for linear filtering).
    hr, hi: length-n frequency response, natural bin order.
    window: length-n taps (default all-ones).

    Per-block numerics = ifft(fft(window * b) * H), 1/n scaled —
    identical to spectral_filter_split on the windowed blocks
    (property-tested sharded == unsharded).
    """
    blocks_r = jnp.asarray(blocks_r)
    blocks_i = jnp.asarray(blocks_i)
    if blocks_r.ndim != 2:
        raise ValueError(
            f"expected [B, n] blocks, got shape {blocks_r.shape}"
        )
    n = int(blocks_r.shape[-1])
    p = mesh.shape[axis_name]
    if N_STAGES % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide {N_STAGES} pipeline "
            f"stages (use 1, 2, or 4 devices on this axis)"
        )
    if window is None:
        window = np.ones(n, np.float32)
    w = jnp.asarray(window, dtype=blocks_r.dtype)
    if int(w.shape[-1]) != n:
        raise ValueError(f"window length {w.shape[-1]} != block size {n}")
    hr = jnp.asarray(hr, dtype=blocks_r.dtype)
    hi = jnp.asarray(hi, dtype=blocks_r.dtype)
    if int(hr.shape[-1]) != n:
        raise ValueError(f"response length {hr.shape[-1]} != block size {n}")
    return _impl(blocks_r, blocks_i, w, hr, hi,
                 axis_name=axis_name, mesh=mesh)
