"""Demo: a large split-plane FFT through the dispatcher.

Analog of the reference's per-module demo mains — run with
``python -m fftlab.cli.bigfft``. Transforms 2^20 points on an
accelerator (2^18 on the CPU, to stay quick) and checks the result
against a float64 NumPy oracle.
"""

from __future__ import annotations

import time

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from fftlab.plan.dispatch import fft_split_auto, select_split_impl
    from fftlab.plan.hardware import detect_hardware

    caps = detect_hardware()
    print(f"hardware: {caps.summary()}\n")
    print("dispatch routes by size:")
    for e in (10, 13, 16, 18, 20, 22, 24, 26, 27):
        n = 1 << e
        print(f"  n=2^{e:<3} -> {select_split_impl(n)}")

    n = 1 << 18 if caps.platform == "cpu" else 1 << 20
    rng = np.random.default_rng(0)
    xr = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)
    xi = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)

    t0 = time.time()
    yr, yi = fft_split_auto(xr, xi)
    got = np.asarray(yr[0], np.float64) + 1j * np.asarray(yi[0], np.float64)
    want = np.fft.fft(np.asarray(xr[0], np.float64)
                      + 1j * np.asarray(xi[0], np.float64))
    snr = 10 * np.log10(np.sum(np.abs(want) ** 2)
                        / np.sum(np.abs(got - want) ** 2))
    print(f"\nfft_split_auto, n=2^{n.bit_length()-1}: "
          f"{snr:.1f} dB vs float64 oracle ({time.time()-t0:.1f}s "
          f"incl. compile, {caps.platform})")

    from fftlab.dsp.convolution import fft_convolution_split

    h = rng.standard_normal(257).astype(np.float32) / 257
    zr, _ = fft_convolution_split(xr[0][: 1 << 14],
                                  jnp.zeros(1 << 14, jnp.float32), h)
    ref = np.convolve(np.asarray(xr[0][: 1 << 14], np.float64),
                      h.astype(np.float64))
    err = float(np.max(np.abs(np.asarray(zr, np.float64) - ref)))
    print(f"fft_convolution_split 16K x 257 taps: max err {err:.2e}")


if __name__ == "__main__":
    main()
