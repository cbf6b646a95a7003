"""Host-native float64 FFT backend (native/fft64.cpp via ctypes).

The framework's second execution backend — the row the reference's
dispatch vtable reserves for its GPU/Metal legs (fft_gpu.c:49-97). The
device leg here is JAX/XLA; this is the genuine host leg: C++ double
precision, batch-first split planes, no JAX involvement at all. Uses:

- independent correctness oracle (a third codebase next to numpy's
  pocketfft and the JAX registry — `tests/test_native_fft64.py`
  cross-checks all three),
- host-side serving when no device is reachable,
- the plan layer's native row (`plan.api.plan_dft_1d_native`), the
  analog of the reference's ALGO_GPU_* plan paths (fft_auto.c:220-229).

Power-of-two sizes only; arbitrary n goes through the Python Bluestein
layer like every other backend.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab.native.lib import load_native_lib


def fft64_split(re, im, inverse: bool = False):
    """Batched c2c FFT on split float64 planes, [..., n] batch-first.

    Forward unscaled / inverse 1/n (radix2_dit.c:115-119 convention).
    Returns new (re, im) float64 arrays of the input shape."""
    # np.array(copy=True) gives exactly ONE fresh contiguous buffer per
    # plane (ascontiguousarray(...).copy() would copy twice for the
    # x.real/x.imag views the complex wrapper feeds in).
    re = np.array(re, dtype=np.float64, order="C")
    im = np.array(im, dtype=np.float64, order="C")
    if re.shape != im.shape:
        raise ValueError(f"plane shapes differ: {re.shape} vs {im.shape}")
    if re.ndim == 0:
        raise ValueError("fft64_split expects [..., n] arrays")
    n = int(re.shape[-1])
    batch = int(np.prod(re.shape[:-1], dtype=np.int64)) if re.ndim > 1 else 1
    lib = load_native_lib()
    rc = lib.fftlab_fft64(
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        batch, n, 1 if inverse else 0,
    )
    if rc != 0:
        raise ValueError(
            f"native fft64 rejected n={n} (power-of-two sizes only)"
        )
    return re, im


def fft64(x, inverse: bool = False) -> np.ndarray:
    """Complex convenience wrapper: complex128 [..., n] in/out."""
    x = np.asarray(x)
    re, im = fft64_split(x.real, x.imag, inverse=inverse)
    return re + 1j * im
