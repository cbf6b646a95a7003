"""Reduced-precision FFT experiments — the analog of the reference's
fixed-point track (optimizations/fixed_point_fft.c).

The reference trades precision for speed with Q15 int16 + block scaling;
here the equivalent knob is the precision of the float32 contractions on
the split-Stockham path. This module exposes the choices and measures
what each costs in SNR — the Q15 C++ oracle (fftlab.native.q15) anchors
the low end.

Modes (what each runs on an NVIDIA GPU; the CPU runs all of them in
float32, except the TF32 preset, which XLA's CPU backend refuses):
  'f32'     Precision.HIGHEST — float32 products outside the tensor
            cores (default)
  'tf32'    Precision.DEFAULT — one TF32 pass on the tensor cores
            (10-bit mantissa inputs); Precision.HIGH is the same on
            this card
  'tf32x3'  DotAlgorithmPreset.TF32_TF32_F32_X3 — three TF32 passes
            (hi/lo split), close to float32
  'bf16x3'  DotAlgorithmPreset.BF16_BF16_F32_X3 — three bf16 passes
            (8-bit mantissa inputs)

Block scaling (fixed_point_fft.c:169-178 per-stage >>1) is unnecessary
in floating point — the exponent IS the block scale.
"""

from __future__ import annotations

import numpy as np

import jax

from fftlab.core.types import FORWARD

_PRECISIONS = {
    "f32": jax.lax.Precision.HIGHEST,
    "tf32": jax.lax.Precision.DEFAULT,
    "tf32x3": jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
    "bf16x3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def fft_split_lowprec(xr, xi, direction=FORWARD, mode: str = "f32",
                      leaf: int = 128):
    """Split-complex FFT at a chosen contraction precision mode.

    Default 'f32' = Precision.HIGHEST, the precision every public
    transform uses — the reduced modes are explicit opt-ins."""
    if mode not in _PRECISIONS:
        raise ValueError(f"mode must be one of {sorted(_PRECISIONS)}")
    from fftlab.algos.split_stockham import fft_split

    return fft_split(xr, xi, direction, leaf,
                     precision=_PRECISIONS[mode])


def snr_vs_oracle(n: int = 4096, batch: int = 2, seed: int = 0,
                  modes=("f32", "tf32", "bf16x3")) -> dict:
    """Measure each mode's SNR against the float64 numpy oracle.

    Returns {mode: snr_db}; include the Q15 native oracle as 'q15' when
    the native library is available.
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    out = {}
    for mode in modes:
        yr, yi = fft_split_lowprec(jnp.asarray(xr), jnp.asarray(xi),
                                   mode=mode)
        got = (np.asarray(yr, dtype=np.float64)
               + 1j * np.asarray(yi, dtype=np.float64))
        err = np.sum(np.abs(got - want) ** 2)
        out[mode] = float(10 * np.log10(np.sum(np.abs(want) ** 2)
                                        / max(err, 1e-300)))
    try:
        from fftlab.native.q15 import q15_fft_float

        z = (xr[0] + 1j * xi[0]) / (4 * np.abs(xr[0] + 1j * xi[0]).max())
        got = q15_fft_float(z)
        wq = np.fft.fft(z)
        out["q15"] = float(10 * np.log10(
            np.sum(np.abs(wq) ** 2)
            / max(np.sum(np.abs(got - wq) ** 2), 1e-300)
        ))
    except (RuntimeError, ImportError):
        pass
    return out
