"""Minimal self-contained 8-point FFT — the legacy demo.

Analog of the reference's standalone fft/fft.c (a fixed N=8 radix-2 DIT
for a Zynq-7000 target, fft/fft.c:12-53) and fft-openmp/fft_openmp.c:
the smallest possible fftlab program, no planner, no DSP layer.

Run: python examples/minimal.py
"""

import numpy as np

try:
    import fftlab
except ImportError:  # fresh checkout without the editable install
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fftlab  # noqa: E402

N = 8

x = np.zeros(N, dtype=np.complex64)
x[1] = 1.0  # unit impulse at t=1 -> spectrum = exp(-2*pi*i*k/8)

X = np.asarray(fftlab.fft(x))
print(f"{'k':>2} {'re':>9} {'im':>9} {'|X|':>7}")
for k in range(N):
    print(f"{k:>2} {X[k].real:>9.4f} {X[k].imag:>9.4f} {abs(X[k]):>7.4f}")

want = np.exp(-2j * np.pi * np.arange(N) / N)
assert np.allclose(X, want, atol=1e-6), "self-test failed"
print("self-test passed: X[k] = W_8^k")
