"""Short-time Fourier transform and inverse.

The analog of the reference's streaming hop/overlap machinery
(examples/realtime_analyzer.c:58-93: circular buffer + hop-size trigger +
window -> FFT). Batched formulation: ALL frames are produced by one
strided gather and transformed as a batch — the frame axis is the natural
sharding axis for the distributed version (dist/stft.py).

Defaults mirror the realtime analyzer config (realtime_analyzer.c:229-235):
fft_size=2048, hop=512 (75% overlap), Hann window.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fftlab.algos.real_fft import irfft, rfft
from fftlab.core.types import Direction, complex_dtype_for
from fftlab.core.window import get_window


def frame_signal(x, frame_size: int, hop: int, pad: bool = True):
    """[..., n] -> [..., n_frames, frame_size] (core/framing.py picks
    the framing strategy)."""
    from fftlab.core.framing import frame_signal_strided

    x = jnp.asarray(x)
    n = int(x.shape[-1])
    if pad:
        n_frames = max(-(-max(n - frame_size, 0) // hop) + 1, 1)
    else:
        n_frames = (n - frame_size) // hop + 1
    return frame_signal_strided(x, frame_size, hop, n_frames)


def stft(x, fft_size: int = 2048, hop: int = 512, window="hann", cfft=None):
    """Real-input STFT: [..., n] -> complex [..., n_frames, fft_size//2+1]."""
    frames = frame_signal(x, fft_size, hop)
    w = jnp.asarray(get_window(window, fft_size), dtype=frames.dtype)
    return rfft(frames * w, cfft)


def stft_complex(x, fft_size: int = 2048, hop: int = 512, window="hann", cfft=None):
    """Complex-input STFT returning the full fft_size spectrum per frame."""
    if cfft is None:
        from fftlab.algos.stockham import stockham_fft as cfft
    frames = frame_signal(x, fft_size, hop)
    cdtype = complex_dtype_for(frames.dtype)
    w = jnp.asarray(get_window(window, fft_size))
    return cfft((frames * w).astype(cdtype), Direction.FORWARD)


def _cola_overlap_add(frames, w: np.ndarray, fft_size: int, hop: int):
    """Windowed COLA overlap-add: [..., n_frames, fft_size] ->
    [..., (n_frames-1)*hop + fft_size], divided by the summed window
    energy. Vectorized when hop divides fft_size: each frame splits
    into k = fft_size/hop hop-chunks and the sum unrolls over k
    diagonal shifts (k whole-array adds), not over n_frames — a
    10-minute stream no longer unrolls tens of thousands of scatter
    ops into the jaxpr."""
    n_frames = int(frames.shape[-2])
    batch = frames.shape[:-2]
    total = (n_frames - 1) * hop + fft_size
    norm = np.zeros(total)
    for f in range(n_frames):
        norm[f * hop: f * hop + fft_size] += w * w
    if fft_size % hop == 0:
        k = fft_size // hop
        f3 = frames.reshape(*batch, n_frames, k, hop)
        out = jnp.zeros((*batch, n_frames + k - 1, hop), frames.dtype)
        for j in range(k):
            out = out.at[..., j:j + n_frames, :].add(f3[..., :, j, :])
        out = out.reshape(*batch, -1)[..., :total]
    else:
        out = jnp.zeros((*batch, total), frames.dtype)
        for f in range(n_frames):
            out = out.at[..., f * hop: f * hop + fft_size].add(
                frames[..., f, :])
    return out / jnp.asarray(np.maximum(norm, 1e-10), dtype=out.dtype)


def istft(S, fft_size: int = 2048, hop: int = 512, window="hann",
          length: int | None = None, cfft=None):
    """Inverse STFT by windowed overlap-add with COLA normalization.

    S: [..., n_frames, fft_size//2+1] complex -> real [..., length].
    """
    S = jnp.asarray(S)
    w = np.asarray(get_window(window, fft_size))
    rdtype = jnp.float32 if S.dtype == jnp.complex64 else jnp.float64
    frames = irfft(S, n=fft_size, cfft=cfft) * jnp.asarray(w, dtype=rdtype)
    out = _cola_overlap_add(frames, w, fft_size, hop)
    if length is not None:
        out = out[..., :length]
    return out


def istft_split(Sr, Si, fft_size: int = 2048, hop: int = 512,
                window="hann", length: int | None = None):
    """Inverse STFT on split planes: one-sided (re, im)
    spectra [n_frames, fft_size//2+1] -> real [total], windowed
    overlap-add with COLA normalization (istft semantics, no complex
    dtype anywhere).

    The overlap-add is vectorized: when hop divides fft_size each frame
    splits into k = fft_size/hop hop-chunks and the sum unrolls over k
    diagonal shifts (k adds of whole arrays), not over n_frames."""
    from fftlab.algos.split_stockham import fft_split
    from fftlab.core.types import Direction

    Sr = jnp.asarray(Sr, dtype=jnp.float32)
    Si = jnp.asarray(Si, dtype=jnp.float32)
    if Sr.ndim != 2:
        raise ValueError(f"istft_split expects [n_frames, bins], got {Sr.shape}")
    if fft_size % 2:
        raise ValueError(
            f"istft_split needs even fft_size (the Hermitian extension "
            f"assumes a Nyquist bin); got {fft_size}"
        )
    h = fft_size // 2 + 1
    if int(Sr.shape[-1]) != h:
        raise ValueError(
            f"expected {h} one-sided bins for fft_size {fft_size}; "
            f"got {Sr.shape[-1]}"
        )
    # Hermitian extension to the full spectrum (even fft_size).
    fr = jnp.concatenate([Sr, jnp.flip(Sr[:, 1:h - 1], -1)], axis=-1)
    fi = jnp.concatenate([Si, -jnp.flip(Si[:, 1:h - 1], -1)], axis=-1)
    yr, _ = fft_split(fr, fi, Direction.INVERSE)
    w = np.asarray(get_window(window, fft_size))
    frames = yr * jnp.asarray(w, dtype=yr.dtype)
    out = _cola_overlap_add(frames, w, fft_size, hop)
    if length is not None:
        out = out[:length]
    return out


def spectrogram(x, fft_size: int = 2048, hop: int = 512, window="hann",
                averaging: int = 1, cfft=None):
    """Magnitude spectrogram with optional exponential frame averaging
    (the EMA of realtime_analyzer.c:75-91, vectorized as a cumulative
    filter when averaging > 1)."""
    S = stft(x, fft_size, hop, window, cfft)
    mag = jnp.abs(S)
    if averaging > 1:
        alpha = 1.0 / averaging
        import jax

        def ema(carry, m):
            carry = (1 - alpha) * carry + alpha * m
            return carry, carry

        init = mag[..., 0, :]
        _, out = jax.lax.scan(ema, init, jnp.moveaxis(mag, -2, 0))
        mag = jnp.moveaxis(out, 0, -2)
    return mag


def stft_split(x, fft_size: int = 2048, hop: int = 512, window="hann",
               onesided: bool = True):
    """STFT of a real 1D signal on split planes: returns (re, im) of
    [n_frames, bins] — no complex dtype anywhere — through strided
    framing and the split-Stockham path. Framing convention: frames
    start at k*hop over the zero-extended signal,
    n_frames = ceil((n - fft_size)/hop) + 1.
    """
    from fftlab.core.framing import frame_signal_strided

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 1:
        raise ValueError(f"stft_split expects a 1D signal, got {x.shape}")
    n = int(x.shape[-1])
    # ceil framing (the docstring's convention, matching stft()'s
    # pad=True): the tail is zero-extended rather than silently dropped.
    n_frames = max(-(-max(n - fft_size, 0) // hop) + 1, 1)
    from fftlab.algos.split_stockham import stockham_fft_split_unscaled
    from fftlab.core.types import Direction

    frames = frame_signal_strided(x, fft_size, hop, n_frames)
    w = jnp.asarray(get_window(window, fft_size), dtype=frames.dtype)
    fr = frames * w
    Xr, Xi = stockham_fft_split_unscaled(
        fr, jnp.zeros_like(fr), Direction.FORWARD
    )
    bins = fft_size // 2 + 1 if onesided else fft_size
    return Xr[..., :bins], Xi[..., :bins]
