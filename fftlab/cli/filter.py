"""FFT filtering demo (applications/fft_filtering.c).

Builds a multi-tone signal, applies LP/HP/BP filters, prints the ASCII
response and before/after spectra (:164-189 response plots).
"""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.algos.real_fft import rfft, rfftfreq
    from fftlab.dsp.filtering import (
        FilterParams,
        FilterType,
        design_response,
        fft_filter,
    )
    from fftlab.utils.plotting import ascii_spectrum
    from fftlab.utils.signals import generate_multi_tone

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--fs", type=float, default=8000.0)
    args = ap.parse_args()

    n, fs = args.n, args.fs
    x = generate_multi_tone(n, [200.0, 1200.0, 3000.0], None, fs)
    freqs = rfftfreq(n, 1.0 / fs)

    print("input spectrum:")
    print(ascii_spectrum(np.abs(np.asarray(rfft(x))), 16, 40, freqs))

    for ft, cut in [(FilterType.LOWPASS, (600.0, 0.0)),
                    (FilterType.HIGHPASS, (2000.0, 0.0)),
                    (FilterType.BANDPASS, (800.0, 2000.0))]:
        params = FilterParams(filter_type=ft, cutoff_low=cut[0],
                              cutoff_high=cut[1], sample_rate=fs,
                              transition_width=100.0)
        y = np.asarray(fft_filter(x, params))
        print(f"\n{ft.value} ({cut[0]:.0f}"
              + (f"-{cut[1]:.0f}" if cut[1] else "") + " Hz) output:")
        print(ascii_spectrum(np.abs(np.asarray(rfft(y))), 16, 40, freqs))
        H = design_response(n, params)
        print(f"  response H: passband gain {np.max(np.abs(H)):.2f}, "
              f"stopband {np.min(np.abs(H)):.2e}")


if __name__ == "__main__":
    main()
