"""Power-spectrum demo (applications/power_spectrum.c).

Periodogram vs Welch on a noisy two-tone signal, spectral statistics,
autocorrelation peak, and magnitude-squared coherence of a filtered pair.
"""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.dsp.spectrum import (
        autocorrelation,
        coherence,
        periodogram,
        spectral_stats,
        welch_psd,
    )
    from fftlab.utils.plotting import ascii_spectrum
    from fftlab.utils.signals import generate_multi_tone, generate_noise

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--fs", type=float, default=1024.0)
    args = ap.parse_args()

    n, fs = args.n, args.fs
    x = generate_multi_tone(n, [64.0, 200.0], [1.0, 0.5], fs)
    x = x + 0.2 * generate_noise(n, seed=7)

    freqs, p = periodogram(x[: 1024], sample_rate=fs)
    print("periodogram (one 1024-pt segment):")
    print(ascii_spectrum(np.asarray(p), 16, 40, freqs, db=True))

    freqs, pw = welch_psd(x, sample_rate=fs, window_size=512, overlap=0.5)
    print("\nWelch PSD (512-pt segments, 50% overlap — variance reduced):")
    print(ascii_spectrum(np.asarray(pw), 16, 40, freqs, db=True))

    stats = spectral_stats(np.asarray(pw), freqs)
    print(f"\nspectral stats: centroid {stats['centroid']:.1f} Hz, "
          f"bandwidth {stats['bandwidth']:.1f} Hz, "
          f"95% rolloff {stats['rolloff_95']:.1f} Hz")

    r = np.asarray(autocorrelation(x))
    lag = int(np.argmax(r[8:256])) + 8
    print(f"autocorrelation: first major peak at lag {lag} "
          f"(~{fs/lag:.1f} Hz periodicity)")

    # Coherence: y = x delayed + independent noise -> high at tone bins.
    y = np.roll(x, 5) + 0.5 * generate_noise(n, seed=8)
    cfreqs, c = coherence(x, y, sample_rate=fs, window_size=512)
    k64 = int(64.0 * 512 / fs)
    print(f"coherence at 64 Hz: {float(np.asarray(c)[k64]):.2f} "
          f"(reference's placeholder would say 1.0 everywhere)")


if __name__ == "__main__":
    main()
