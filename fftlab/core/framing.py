"""Overlapping-frame construction with a selectable strategy.

Every streaming pipeline (overlap-save, STFT, Welch) needs the view
frames[k] = x[k*hop : k*hop + frame_size]. Three implementations exist;
all three are exact copies of the input samples:

- ``gather``  jnp fancy-index gather.
- ``patches`` `lax.conv_general_dilated_patches` — XLA's native sliding
              window, a convolution against one-hot filters. It runs at
              Precision.HIGHEST: at a lower precision a GPU is free to
              use TF32, which would round samples to a 10-bit mantissa.
- ``slices``  hop-block reshape + shifted-slice concat.

Default: ``slices``, the fastest of the three on an NVIDIA H100 (700 W):
framing 2^22 samples at 2048/512 took 0.20 ms against 0.28 ms for
``gather`` and 7.6 ms for ``patches``; 2^23 samples at 1024/896 took
0.22, 0.34 and 2.5 ms. Override with
``FFTLAB_FRAMING={gather,patches,slices}``.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp


_STRATEGIES = ("gather", "patches", "slices")
DEFAULT_STRATEGY = "slices"


def _strategy() -> str:
    env = os.environ.get("FFTLAB_FRAMING")
    if env:
        if env not in _STRATEGIES:
            raise ValueError(
                f"FFTLAB_FRAMING={env!r}; want one of {_STRATEGIES}"
            )
        return env
    return DEFAULT_STRATEGY


def _pad_to(x, need: int):
    total = int(x.shape[-1])
    if total < need:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, need - total)]
        return jnp.pad(x, pad)
    if total > need:
        return x[..., :need]
    return x


def _frames_gather(x, frame_size, hop, n_frames):
    starts = np.arange(n_frames) * hop
    idx = starts[:, None] + np.arange(frame_size)[None, :]
    return x[..., idx]


def _frames_patches(x, frame_size, hop, n_frames):
    need = (n_frames - 1) * hop + frame_size
    batch = x.shape[:-1]
    B = int(np.prod(batch)) if batch else 1
    patches = jax.lax.conv_general_dilated_patches(
        x.reshape(B, 1, need),
        filter_shape=[frame_size],
        window_strides=[hop],
        padding="VALID",
        precision=jax.lax.Precision.HIGHEST,
    )  # (B, frame_size, n_frames)
    out = jnp.swapaxes(patches, -1, -2)
    return out.reshape(*batch, n_frames, frame_size)


def _frames_slices(x, frame_size, hop, n_frames):
    q = -(-frame_size // hop)
    need_blocks = n_frames + q
    x = _pad_to(x, need_blocks * hop)
    blocks = x.reshape(*x.shape[:-1], need_blocks, hop)
    views = [blocks[..., j : j + n_frames, :] for j in range(q)]
    return jnp.concatenate(views, axis=-1)[..., :frame_size]


def frame_signal_strided(x, frame_size: int, hop: int, n_frames: int):
    """[..., total] -> [..., n_frames, frame_size] with frames starting
    at k*hop. `x` may be shorter (zero-extended) or longer (excess
    ignored) than the required span."""
    if hop <= 0 or frame_size <= 0:
        raise ValueError(f"bad framing: frame={frame_size}, hop={hop}")
    x = jnp.asarray(x)
    strat = _strategy()
    if strat == "slices":
        return _frames_slices(x, frame_size, hop, n_frames)
    x = _pad_to(x, (n_frames - 1) * hop + frame_size)
    if strat == "patches":
        return _frames_patches(x, frame_size, hop, n_frames)
    return _frames_gather(x, frame_size, hop, n_frames)


def frames_needed(total: int, frame_size: int, hop: int) -> int:
    """Frame count for 'valid' framing: floor((total - frame)/hop) + 1."""
    return max((total - frame_size) // hop + 1, 1)
