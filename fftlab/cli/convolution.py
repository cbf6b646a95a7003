"""Convolution demo (applications/convolution.c): direct vs FFT vs
circular vs streaming overlap-save/overlap-add, with agreement checks."""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.dsp.convolution import (
        circular_convolution,
        direct_convolution,
        fft_convolution,
        overlap_add,
        overlap_save,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--nh", type=int, default=101)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    x = rng.standard_normal(args.nx)
    h = rng.standard_normal(args.nh)

    ref = np.asarray(direct_convolution(x, h))
    # Without x64 enabled JAX computes in float32; scale the agreement
    # bound to the working precision.
    tol = 1e-8 if ref.dtype == np.float64 else 1e-3
    print(f"linear convolution of {args.nx} x {args.nh} "
          f"-> {ref.shape[-1]} samples")
    for name, fn in [("fft_convolution", fft_convolution),
                     ("overlap_save", overlap_save),
                     ("overlap_add", overlap_add)]:
        got = np.asarray(fn(x, h))
        err = np.max(np.abs(got - ref))
        print(f"  {name:<16} max err vs direct: {err:.2e} "
              f"{'OK' if err < tol else 'FAIL'}")

    xc = rng.standard_normal(1024)
    hc = rng.standard_normal(1024)
    cc = np.asarray(circular_convolution(xc, hc))
    want = np.real(np.fft.ifft(np.fft.fft(xc) * np.fft.fft(hc)))
    print(f"  circular (1024)   max err vs numpy:  "
          f"{np.max(np.abs(cc - want)):.2e}")


if __name__ == "__main__":
    main()
