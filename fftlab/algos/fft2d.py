"""2D FFT by row-column decomposition, plus fftshift.

The analog of reference applications/image_fft.c:35-96. The
reference's column pass is a strided gather/scatter per column
(image_fft.c:46-61); here both passes are batched transforms over the last
axis with one transpose between — the transpose is a single tiled HBM op
under XLA, and the column FFTs are exactly as fast as row FFTs.

Inverse applies the 1/(rows*cols) scaling (image_fft.c:63-71) via the two
1/n factors of the per-axis inverse transforms.
"""

from __future__ import annotations

import jax.numpy as jnp

from fftlab.core.types import FORWARD, INVERSE


def _default_cfft():
    from fftlab.algos.stockham import stockham_fft

    return stockham_fft


def fft2(x, direction=FORWARD, cfft=None):
    """2D FFT over the last two axes of [..., rows, cols]."""
    if cfft is None:
        cfft = _default_cfft()
    x = cfft(x, direction)  # rows: transform cols axis
    x = jnp.swapaxes(x, -1, -2)
    x = cfft(x, direction)  # cols
    return jnp.swapaxes(x, -1, -2)


def ifft2(x, cfft=None):
    return fft2(x, INVERSE, cfft)


def fftn(x, axes=None, direction=FORWARD, cfft=None):
    """N-D FFT over `axes` (default: all axes)."""
    if cfft is None:
        cfft = _default_cfft()
    if axes is None:
        axes = range(x.ndim)
    for ax in axes:
        x = jnp.moveaxis(cfft(jnp.moveaxis(x, ax, -1), direction), -1, ax)
    return x


def fftshift(x, axes=None):
    """Move zero-frequency to the center (image_fft.c:75-96)."""
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    shift = [x.shape[a] // 2 for a in axes]
    return jnp.roll(x, shift, axis=tuple(axes))


def ifftshift(x, axes=None):
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    shift = [-(x.shape[a] // 2) for a in axes]
    return jnp.roll(x, shift, axis=tuple(axes))
