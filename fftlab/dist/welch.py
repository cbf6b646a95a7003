"""Welch PSD with segments sharded across devices and ``psum`` averaging.

A re-design of the reference's Welch method
(power_spectrum.c:88-130): the overlapping segments are embarrassingly
parallel (SURVEY.md §2.2), so they shard over the mesh as a batch dim and
the average becomes one `psum` over the mesh axis — replacing nothing in the
reference (it averages serially on one core).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.stockham import stockham_fft_unscaled
from fftlab.core.types import Direction, complex_dtype_for
from fftlab.core.window import get_window, power_gain

from jax import shard_map


@functools.partial(
    jax.jit,
    static_argnames=("window_size", "hop", "n_seg", "axis_name", "mesh",
                     "sample_rate", "pgain"),
)
def _welch_sharded_impl(x, w, *, window_size: int, hop: int, n_seg: int,
                        axis_name: str, mesh: Mesh, sample_rate: float,
                        pgain: float):
    p = mesh.shape[axis_name]
    per = -(-n_seg // p)  # segments per device (last device may pad)
    h = window_size // 2 + 1

    def local(xl, wl):
        from fftlab.core.framing import frame_signal_strided

        dev = jax.lax.axis_index(axis_name)
        base = dev * per
        span = (per - 1) * hop + window_size
        xs = jax.lax.dynamic_slice_in_dim(xl, base * hop, span)
        segs = frame_signal_strided(xs, window_size, hop, per) * wl[None, :]
        cdtype = complex_dtype_for(segs.dtype)
        X = stockham_fft_unscaled(segs.astype(cdtype), Direction.FORWARD)
        psd = (jnp.real(X) ** 2 + jnp.imag(X) ** 2)[:, :h]
        # Mask padded segments on the last device.
        valid = (jnp.arange(per) + base) < n_seg
        psd = jnp.where(valid[:, None], psd, 0.0)
        total = jax.lax.psum(jnp.sum(psd, axis=0), axis_name)
        return (total / n_seg)[None, :]

    # x is replicated; pad so every device's gather is in-bounds.
    need = ((p * per - 1) * hop) + window_size
    xp = jnp.pad(x, (0, max(need - int(x.shape[-1]), 0)))
    psd = shard_map(
        local, mesh=mesh, in_specs=(P(), P()), out_specs=P()
    )(xp, w)[0]
    scale = 1.0 / (sample_rate * window_size * pgain)
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if window_size % 2 == 0:
        dbl[-1] = 1.0
    return psd * scale * jnp.asarray(dbl, dtype=psd.dtype)


def welch_psd_sharded(x, mesh: Mesh, axis_name: str = "dp",
                      sample_rate: float = 1.0, window_size: int = 256,
                      overlap: float = 0.5, window="hann"):
    """Sharded Welch PSD of a real 1D signal. Returns (freqs, psd) matching
    ``fftlab.dsp.spectrum.welch_psd`` (property-tested equal)."""
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError(
            f"welch_psd_sharded expects a 1D signal, got shape {x.shape} "
            f"(batch the unsharded dsp.spectrum.welch_psd, or vmap)"
        )
    n = int(x.shape[-1])
    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    w = get_window(window, window_size)
    psd = _welch_sharded_impl(
        x, jnp.asarray(w, dtype=x.dtype),
        window_size=window_size, hop=hop, n_seg=n_seg, axis_name=axis_name,
        mesh=mesh, sample_rate=float(sample_rate), pgain=power_gain(w),
    )
    freqs = np.arange(window_size // 2 + 1) * sample_rate / window_size
    return freqs, psd
