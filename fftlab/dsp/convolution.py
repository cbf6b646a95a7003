"""Convolution: direct, FFT-based linear/circular, and block-streaming
overlap-save / overlap-add.

The analog of reference applications/convolution.c: direct O(n^2)
(:20-31), FFT linear convolution with next-pow2 zero padding (:34-68),
circular convolution (:71-96) — plus real implementations of overlap-add
and overlap-save, which the reference only describes in comments
(convolution.c:284-290). 2D convolution (reference placeholder :99-109)
is implemented via the 2D FFT.

Everything is batched over leading axes. The sharded multi-device
overlap-save lives in dist/overlap_save.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.core.types import Direction, complex_dtype_for, next_power_of_two


def _cfft():
    from fftlab.algos.stockham import stockham_fft

    return stockham_fft


def _pad_last(x, total: int):
    pad = [(0, 0)] * (x.ndim - 1) + [(0, total - x.shape[-1])]
    return jnp.pad(x, pad)


def direct_convolution(x, h):
    """O(n*m) time-domain convolution (convolution.c:20-31) — the oracle.
    Implemented with XLA's native correlation primitive."""
    x = jnp.asarray(x, dtype=jnp.result_type(x, h))
    h = jnp.asarray(h, dtype=x.dtype)
    batch = x.shape[:-1]
    xn = x.reshape(int(np.prod(batch)) if batch else 1, 1, x.shape[-1])
    hn = h[::-1].reshape(1, 1, h.shape[-1])
    y = jax.lax.conv_general_dilated(
        xn, hn, window_strides=(1,), padding=[(h.shape[-1] - 1, h.shape[-1] - 1)],
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(*batch, x.shape[-1] + h.shape[-1] - 1)


def fft_convolution(x, h, cfft=None):
    """Linear convolution via FFT: zero-pad to next_pow2(nx+nh-1), two
    forward FFTs, pointwise multiply, inverse FFT, truncate
    (convolution.c:34-68)."""
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    was_real = np.dtype(x.dtype).kind != "c" and np.dtype(h.dtype).kind != "c"
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    m = next_power_of_two(nx + nh - 1)
    cdtype = complex_dtype_for(jnp.result_type(x, h))
    X = cfft(_pad_last(x.astype(cdtype), m), Direction.FORWARD)
    H = cfft(_pad_last(h.astype(cdtype), m), Direction.FORWARD)
    y = cfft(X * H, Direction.INVERSE)[..., : nx + nh - 1]
    return jnp.real(y) if was_real else y


def circular_convolution(x, h, cfft=None):
    """Circular convolution of equal-length signals (convolution.c:71-96)."""
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    if x.shape[-1] != h.shape[-1]:
        raise ValueError("circular convolution requires equal lengths")
    was_real = np.dtype(x.dtype).kind != "c" and np.dtype(h.dtype).kind != "c"
    cdtype = complex_dtype_for(jnp.result_type(x, h))
    y = cfft(
        cfft(x.astype(cdtype), Direction.FORWARD)
        * cfft(h.astype(cdtype), Direction.FORWARD),
        Direction.INVERSE,
    )
    return jnp.real(y) if was_real else y


def overlap_save(x, h, block: int | None = None, cfft=None):
    """Streaming linear convolution by overlap-save (the method
    convolution.c:284-290 describes but never implements).

    Splits x into hops of size B = fft_size - (nh-1); each block is the
    current hop prefixed by the previous (nh-1) samples; per block:
    FFT -> H -> IFFT -> keep the last B samples. Returns the same
    'same-ish' output as fft_convolution truncated to nx + nh - 1.

    The block loop is a `lax.scan`-free reshape: all blocks are formed by
    one strided gather and processed as a batch (blocks become the
    batch dim; the sharded version distributes them).
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    was_real = np.dtype(x.dtype).kind != "c" and np.dtype(h.dtype).kind != "c"
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    if block is None:
        block = max(next_power_of_two(4 * nh), 256)
    fft_size = next_power_of_two(block)
    hop = fft_size - (nh - 1)
    n_out = nx + nh - 1
    n_blocks = -(-n_out // hop)

    cdtype = complex_dtype_for(jnp.result_type(x, h))
    H = cfft(_pad_last(h.astype(cdtype), fft_size), Direction.FORWARD)

    # Left-pad with the (nh-1)-sample halo; the strided framer right-pads.
    from fftlab.core.framing import frame_signal_strided

    pad = [(0, 0)] * (x.ndim - 1) + [(nh - 1, 0)]
    xp = jnp.pad(x.astype(cdtype), pad)
    frames = frame_signal_strided(xp, fft_size, hop, n_blocks)
    Y = cfft(frames, Direction.FORWARD) * H
    y = cfft(Y, Direction.INVERSE)[..., nh - 1 :]  # keep valid tail of each block
    y = y.reshape(*y.shape[:-2], n_blocks * hop)[..., :n_out]
    return jnp.real(y) if was_real else y


def overlap_add(x, h, block: int | None = None, cfft=None):
    """Overlap-add block convolution (convolution.c:284-290 description).

    x split into disjoint blocks of size B; each zero-padded to
    fft_size >= B + nh - 1, filtered, and the (nh-1)-sample tails summed
    into the next block's head via a shifted scatter-add.
    """
    if cfft is None:
        cfft = _cfft()
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    was_real = np.dtype(x.dtype).kind != "c" and np.dtype(h.dtype).kind != "c"
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    if block is None:
        block = max(next_power_of_two(4 * nh), 256)
    fft_size = next_power_of_two(block + nh - 1)
    n_blocks = -(-nx // block)
    n_out = nx + nh - 1

    cdtype = complex_dtype_for(jnp.result_type(x, h))
    H = cfft(_pad_last(h.astype(cdtype), fft_size), Direction.FORWARD)
    xp = _pad_last(x.astype(cdtype), n_blocks * block)
    frames = xp.reshape(*x.shape[:-1], n_blocks, block)
    frames = jnp.pad(frames, [(0, 0)] * (frames.ndim - 1) + [(0, fft_size - block)])
    y = cfft(cfft(frames, Direction.FORWARD) * H, Direction.INVERSE)
    # Overlap-add: block b contributes y[b] at offset b*block. Since the
    # placement stride IS the block size, pad each filtered frame to
    # k*block and sum k diagonal shifts — k (= ceil(fft_size/block),
    # typically 2-4) whole-array adds instead of n_blocks scatter-adds
    # (a 1M-sample signal at block=256 would otherwise unroll ~4k
    # sequential dynamic-update-slices into the jaxpr).
    k = -(-fft_size // block)
    yk = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, k * block - fft_size)])
    yk = yk.reshape(*y.shape[:-2], n_blocks, k, block)
    out = jnp.zeros((*x.shape[:-1], n_blocks + k, block), dtype=cdtype)
    for j in range(k):
        out = out.at[..., j:j + n_blocks, :].add(yk[..., :, j, :])
    out = out.reshape(*x.shape[:-1], -1)[..., :n_out]
    return jnp.real(out) if was_real else out


def convolve2d(img, kernel, cfft=None):
    """2D linear convolution via the 2D FFT (implements the reference's
    placeholder, convolution.c:99-109)."""
    from fftlab.algos.fft2d import fft2

    img = jnp.asarray(img)
    kernel = jnp.asarray(kernel)
    was_real = (
        np.dtype(img.dtype).kind != "c" and np.dtype(kernel.dtype).kind != "c"
    )
    r = img.shape[-2] + kernel.shape[-2] - 1
    c = img.shape[-1] + kernel.shape[-1] - 1
    rp, cp = next_power_of_two(r), next_power_of_two(c)
    cdtype = complex_dtype_for(jnp.result_type(img, kernel))

    def pad2(a):
        pads = [(0, 0)] * (a.ndim - 2) + [
            (0, rp - a.shape[-2]),
            (0, cp - a.shape[-1]),
        ]
        return jnp.pad(a.astype(cdtype), pads)

    Y = fft2(pad2(img), Direction.FORWARD, cfft) * fft2(pad2(kernel), Direction.FORWARD, cfft)
    y = fft2(Y, Direction.INVERSE, cfft)[..., :r, :c]
    return jnp.real(y) if was_real else y


def fft_convolution_split(xr, xi, h):
    """Linear convolution on split re/im planes (the device serving path;
    convolution.c:34-68 semantics — zero-pad to pow2, FFT, pointwise,
    IFFT, truncate). Returns (yr, yi) of length nx + nh - 1, through the
    fused zero-transpose sandwich of plan.dispatch.spectral_filter_auto.
    """
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import stockham_fft_split_unscaled
    from fftlab.core.types import Direction, next_power_of_two
    from fftlab.plan.dispatch import spectral_filter_auto

    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    nx, nh = int(xr.shape[-1]), int(h.shape[-1])
    out_len = nx + nh - 1
    m = next_power_of_two(out_len)
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - nx)]
    xpr = jnp.pad(xr, pad)
    xpi = jnp.pad(xi, pad)
    hp = jnp.pad(h, (0, m - nh))
    Hr, Hi = stockham_fft_split_unscaled(
        hp, jnp.zeros_like(hp), Direction.FORWARD
    )
    # Route policy lives in plan.dispatch; H is computed on-device so
    # the einsum route's permute happens wherever H lives.
    yr, yi = spectral_filter_auto(xpr, xpi, Hr, Hi)
    return yr[..., :out_len], yi[..., :out_len]
