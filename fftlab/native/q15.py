"""Q15 fixed-point FFT bindings (native/q15_fft.cpp).

The reduced-precision reference track (optimizations/fixed_point_fft.c):
Q15 int16 samples, per-stage >>1 block scaling, block-floating-point
normalization. The reduced-precision experiments (algos/lowprec.py)
validate against this oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab.native.lib import load_native_lib


def float_to_q15(x) -> np.ndarray:
    """[-1, 1) floats -> Q15 int16 with saturation (fixed_point_fft.c:42-52)."""
    a = np.asarray(x, dtype=np.float64)
    return np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16)


def q15_to_float(q) -> np.ndarray:
    return np.asarray(q, dtype=np.float64) / 32768.0


def q15_fft(re, im, inverse: bool = False) -> tuple[np.ndarray, np.ndarray, int]:
    """In-place-semantics Q15 FFT; returns (re, im, block_exponent).

    True spectrum values are q15_to_float(out) * 2**block_exponent
    (forward); the inverse applies the same per-stage scaling so a
    forward+inverse round trip recovers x after multiplying by
    2**(exp_fwd + exp_inv) / n ... with the reference's convention the
    two log2(n) scalings ARE the 1/n, so round trip is exact up to Q15
    noise.
    """
    lib = load_native_lib()
    r = np.ascontiguousarray(np.asarray(re, dtype=np.int16)).copy()
    i = np.ascontiguousarray(np.asarray(im, dtype=np.int16)).copy()
    if r.shape != i.shape or r.ndim != 1:
        raise ValueError("q15_fft expects matching 1D int16 arrays")
    n = len(r)
    rc = lib.fftlab_q15_fft(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n, 1 if inverse else 0,
    )
    if rc < 0:
        raise ValueError(f"q15_fft: n={n} must be a power of two >= 2")
    return r, i, rc


def q15_normalize(re, im) -> tuple[np.ndarray, np.ndarray, int]:
    """Block-floating-point normalize; returns (re, im, left_shifts)."""
    lib = load_native_lib()
    r = np.ascontiguousarray(np.asarray(re, dtype=np.int16)).copy()
    i = np.ascontiguousarray(np.asarray(im, dtype=np.int16)).copy()
    shifts = lib.fftlab_q15_normalize(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(r),
    )
    return r, i, shifts


def q15_fft_float(x, inverse: bool = False) -> np.ndarray:
    """Convenience: complex float in, complex float out. Input must be
    scaled to |x| < 1.

    The per-stage >>1 shifts make the kernel compute DFT/n in both
    directions; forward multiplies the block exponent (2^log2n = n) back
    in to give the unscaled spectrum, while for the inverse DFT/n IS the
    correctly 1/n-scaled result (reference convention), so the exponent
    is not applied.
    """
    x = np.asarray(x, dtype=np.complex128)
    r, i, exp = q15_fft(float_to_q15(x.real), float_to_q15(x.imag), inverse)
    scale = 1.0 if inverse else float(2 ** exp)
    return (q15_to_float(r) + 1j * q15_to_float(i)) * scale
