"""Frame-sharded STFT: the streaming analyzer's hop/overlap loop
(realtime_analyzer.c:58-93) distributed over a mesh.

The signal's time axis is sharded into contiguous chunks; each device owns
the frames whose start index falls inside its chunk. Because consecutive
frames overlap by (fft_size - hop) samples, a device's last frames reach
into the next chunk — the right neighbor sends that head with one
`ppermute` (mirror image of the overlap-save halo, which flows leftward).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fftlab.algos.stockham import stockham_fft_unscaled
from fftlab.core.types import Direction, complex_dtype_for
from fftlab.core.window import get_window

from jax import shard_map


@functools.partial(
    jax.jit,
    static_argnames=("fft_size", "hop", "axis_name", "mesh", "onesided"),
)
def _stft_sharded_impl(x, w, *, fft_size: int, hop: int, axis_name: str,
                       mesh: Mesh, onesided: bool):
    p = mesh.shape[axis_name]
    n = int(x.shape[-1])
    chunk = n // p
    halo = fft_size - hop
    bins = fft_size // 2 + 1 if onesided else fft_size

    def local(xl, wl):
        # Right neighbor's head completes this device's trailing frames.
        if halo > 0:
            head = jax.lax.ppermute(
                xl[..., :halo], axis_name,
                perm=[(i + 1, i) for i in range(p - 1)],
            )  # last device receives zeros = tail zero padding
            xp = jnp.concatenate([xl, head], axis=-1)
        else:
            xp = xl
        from fftlab.core.framing import frame_signal_strided

        frames = frame_signal_strided(xp, fft_size, hop, chunk // hop) * wl
        cdtype = complex_dtype_for(frames.dtype)
        X = stockham_fft_unscaled(frames.astype(cdtype), Direction.FORWARD)
        return X[..., :bins]

    bnd = x.ndim - 1
    spec_in = P(*([None] * bnd), axis_name)
    spec_out = P(*([None] * bnd), axis_name, None)
    return shard_map(
        local, mesh=mesh, in_specs=(spec_in, P()), out_specs=spec_out
    )(x, w)


def stft_sharded(x, mesh: Mesh, axis_name: str = "sp",
                 fft_size: int = 2048, hop: int = 512, window="hann",
                 onesided: bool | None = None):
    """Sharded STFT: [..., n] -> [..., n//hop, bins] with the frame axis
    sharded over `mesh[axis_name]`.

    Framing convention: frames start at k*hop for k in [0, n//hop); the
    signal is zero-extended at the tail (the analyzer's steady-state
    streaming view). Requires hop | chunk and chunk >= fft_size - hop.
    """
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    p = mesh.shape[axis_name]
    if n % p:
        raise ValueError(f"n={n} not divisible by {axis_name}={p}")
    chunk = n // p
    if chunk % hop:
        raise ValueError(f"chunk {chunk} not divisible by hop {hop}")
    if fft_size - hop > chunk:
        raise ValueError(
            f"frame overlap {fft_size - hop} exceeds chunk {chunk}"
        )
    if onesided is None:
        onesided = np.dtype(x.dtype).kind != "c"
    w = jnp.asarray(get_window(window, fft_size),
                    dtype=np.float64 if x.dtype == jnp.float64 else np.float32)
    return _stft_sharded_impl(
        x, w, fft_size=fft_size, hop=hop, axis_name=axis_name, mesh=mesh,
        onesided=bool(onesided),
    )
