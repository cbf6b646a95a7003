"""2D image-domain FFT processing.

The analog of reference applications/image_fft.c: frequency-domain
ideal low-pass and Gaussian filters (:147-178), high-pass edge detection
(:214-235), fftshift (:75-96), and the 2D test-pattern generators
(:99-144). The 2D transform itself is algos/fft2d.py (row-column
decomposition as two batched last-axis transforms + one tiled transpose).

All filters are built host-side in float64 as [rows, cols] masks centered
per fftshift convention, then applied as one fused pointwise multiply in
the FFT -> mask -> IFFT sandwich.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from fftlab.algos.fft2d import fft2, fftshift, ifft2, ifftshift  # lint: ok
from fftlab.core.types import Direction, complex_dtype_for


# ---------------------------------------------------------------------------
# Test-pattern generators (image_fft.c:99-144)
# ---------------------------------------------------------------------------


def generate_2d_sinusoid(rows: int, cols: int, fy: float, fx: float,
                         amplitude: float = 1.0) -> np.ndarray:
    """cos(2*pi*(fy*y/rows + fx*x/cols)) (image_fft.c:99-112)."""
    y = np.arange(rows, dtype=np.float64)[:, None]
    x = np.arange(cols, dtype=np.float64)[None, :]
    return amplitude * np.cos(2 * np.pi * (fy * y / rows + fx * x / cols))


def generate_2d_gaussian(rows: int, cols: int, sigma: float,
                         amplitude: float = 1.0) -> np.ndarray:
    """Centered Gaussian blob (image_fft.c:114-127)."""
    y = np.arange(rows, dtype=np.float64)[:, None] - rows / 2.0
    x = np.arange(cols, dtype=np.float64)[None, :] - cols / 2.0
    return amplitude * np.exp(-(y * y + x * x) / (2.0 * sigma * sigma))


def generate_2d_rect(rows: int, cols: int, height: int, width: int,
                     amplitude: float = 1.0) -> np.ndarray:
    """Centered rectangle (image_fft.c:129-144)."""
    img = np.zeros((rows, cols), dtype=np.float64)
    y0, x0 = (rows - height) // 2, (cols - width) // 2
    img[y0 : y0 + height, x0 : x0 + width] = amplitude
    return img


# ---------------------------------------------------------------------------
# Frequency-domain masks (image_fft.c:147-178, 214-235)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _radius_grid(rows: int, cols: int) -> np.ndarray:
    """Distance from the zero-frequency bin in UNSHIFTED layout (wrapped
    frequencies, matching the reference's k > n/2 negative-frequency
    handling, image_fft.c:151-160)."""
    fy = np.minimum(np.arange(rows), rows - np.arange(rows)).astype(np.float64)
    fx = np.minimum(np.arange(cols), cols - np.arange(cols)).astype(np.float64)
    return np.hypot(fy[:, None], fx[None, :])


def ideal_lowpass_mask(rows: int, cols: int, cutoff: float) -> np.ndarray:
    """Brick-wall LP: 1 inside radius `cutoff` (image_fft.c:147-162)."""
    return (_radius_grid(rows, cols) <= cutoff).astype(np.float64)


def ideal_highpass_mask(rows: int, cols: int, cutoff: float) -> np.ndarray:
    """Brick-wall HP (edge detection mask, image_fft.c:214-224)."""
    return 1.0 - ideal_lowpass_mask(rows, cols, cutoff)


def gaussian_lowpass_mask(rows: int, cols: int, sigma: float) -> np.ndarray:
    """Gaussian LP: exp(-r^2 / (2*sigma^2)) (image_fft.c:164-178)."""
    r = _radius_grid(rows, cols)
    return np.exp(-(r * r) / (2.0 * sigma * sigma))


def gaussian_highpass_mask(rows: int, cols: int, sigma: float) -> np.ndarray:
    return 1.0 - gaussian_lowpass_mask(rows, cols, sigma)


def apply_frequency_mask(img, mask, cfft=None):
    """FFT2 -> mask -> IFFT2; returns real image for real input."""
    img = jnp.asarray(img)
    was_real = np.dtype(img.dtype).kind != "c"
    cdtype = complex_dtype_for(img.dtype)
    X = fft2(img.astype(cdtype), Direction.FORWARD, cfft)
    Y = X * jnp.asarray(np.asarray(mask), dtype=cdtype)
    y = ifft2(Y, cfft)
    return jnp.real(y) if was_real else y


def lowpass_filter_image(img, cutoff: float, kind: str = "ideal", cfft=None):
    """Frequency-domain LP (image_fft.c ideal_lowpass_filter /
    gaussian_lowpass_filter)."""
    rows, cols = int(img.shape[-2]), int(img.shape[-1])
    if kind == "ideal":
        mask = ideal_lowpass_mask(rows, cols, cutoff)
    elif kind == "gaussian":
        mask = gaussian_lowpass_mask(rows, cols, cutoff)
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return apply_frequency_mask(img, mask, cfft)


def highpass_filter_image(img, cutoff: float, kind: str = "ideal", cfft=None):
    rows, cols = int(img.shape[-2]), int(img.shape[-1])
    if kind == "ideal":
        mask = ideal_highpass_mask(rows, cols, cutoff)
    elif kind == "gaussian":
        mask = gaussian_highpass_mask(rows, cols, cutoff)
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return apply_frequency_mask(img, mask, cfft)


def detect_edges(img, cutoff: float | None = None, cfft=None):
    """Edge detection = high-pass in the frequency domain, magnitude
    output (image_fft.c:214-235)."""
    rows, cols = int(img.shape[-2]), int(img.shape[-1])
    if cutoff is None:
        cutoff = min(rows, cols) / 8.0
    return jnp.abs(highpass_filter_image(img, cutoff, "ideal", cfft))


def log_magnitude_spectrum(img, cfft=None):
    """Shifted log-magnitude display spectrum (the reference's ASCII
    display prep, image_fft.c:181-211)."""
    img = jnp.asarray(img)
    cdtype = complex_dtype_for(img.dtype)
    X = fft2(img.astype(cdtype), Direction.FORWARD, cfft)
    return jnp.log1p(jnp.abs(fftshift(X, axes=(-2, -1))))
