"""2D FFT image demo (applications/image_fft.c).

Generates test patterns, shows their shifted log-magnitude spectra and
the effect of frequency-domain filters as ASCII images.
"""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.dsp.image import (
        detect_edges,
        generate_2d_gaussian,
        generate_2d_rect,
        generate_2d_sinusoid,
        log_magnitude_spectrum,
        lowpass_filter_image,
    )
    from fftlab.utils.plotting import ascii_image

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=64)
    args = ap.parse_args()

    r = c = args.size
    for name, img in [
        ("2D sinusoid (4,2 cycles)", generate_2d_sinusoid(r, c, 4, 2)),
        ("Gaussian blob", generate_2d_gaussian(r, c, r / 8)),
        ("rectangle", generate_2d_rect(r, c, r // 4, c // 4)),
    ]:
        print(f"\n=== {name} ===")
        print(ascii_image(img, 48, 16))
        print("log-magnitude spectrum (shifted):")
        print(ascii_image(np.asarray(log_magnitude_spectrum(img)), 48, 16))

    rect = generate_2d_rect(r, c, r // 3, c // 3)
    print("\nGaussian low-pass of rectangle (blur):")
    print(ascii_image(np.asarray(
        lowpass_filter_image(rect, r / 10, "gaussian")), 48, 16))
    print("\nedge detection (high-pass magnitude):")
    print(ascii_image(np.asarray(detect_edges(rect)), 48, 16))


if __name__ == "__main__":
    main()
