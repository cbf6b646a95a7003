"""Streaming spectrum analyzer demo (examples/realtime_analyzer.c).

Feeds a time-varying test signal (sweep + harmonics, :149-178) through the
streaming analyzer in hop-sized chunks and renders ASCII spectrum frames
(:104-146). `--frames N` limits output; `--live` uses ANSI clear between
frames.
"""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.algos.real_fft import rfftfreq
    from fftlab.dsp.analyzer import AnalyzerConfig, RealtimeAnalyzer
    from fftlab.utils.plotting import ansi_clear, ascii_spectrum

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--fft-size", type=int, default=2048)
    ap.add_argument("--hop", type=int, default=512)
    ap.add_argument("--wav", default=None,
                    help="analyze a WAV file (native reader) instead of "
                         "the synthetic sweep")
    args = ap.parse_args()

    if args.wav:
        from fftlab.native.wav import read_wav

        sig, fs = read_wav(args.wav)
        if sig.ndim == 2:
            sig = sig.mean(axis=1)  # downmix to mono
        sig = sig.astype(np.float32)
        cfg = AnalyzerConfig(fft_size=args.fft_size, hop=args.hop,
                             sample_rate=float(fs))
        total = len(sig)
    else:
        cfg = AnalyzerConfig(fft_size=args.fft_size, hop=args.hop)
        # Time-varying signal: sweeping fundamental + fixed harmonics
        # (realtime_analyzer.c:149-178).
        total = args.frames * cfg.hop * 4
        fs = cfg.sample_rate
        t = np.arange(total) / fs
        f0 = 440.0 + 400.0 * np.sin(2 * np.pi * 0.5 * t)
        phase = 2 * np.pi * np.cumsum(f0) / fs
        sig = (np.sin(phase) + 0.5 * np.sin(2 * phase)
               + 0.25 * np.sin(3 * phase)).astype(np.float32)

    an = RealtimeAnalyzer(cfg)
    freqs = rfftfreq(cfg.fft_size, 1.0 / cfg.sample_rate)

    shown = 0
    for i in range(0, total, cfg.hop * 4):
        avg = an.process(sig[i : i + cfg.hop * 4])
        if avg is None:
            continue
        header = ansi_clear() if args.live else f"\n--- frame {shown} ---\n"
        print(header + ascii_spectrum(avg[: len(avg) // 8], n_bins=24,
                                      width=48, freqs=freqs))
        for p in an.peaks()[:3]:
            print(f"  peak {p.freq:8.1f} Hz  {p.note:<4} "
                  f"({p.cents:+.0f} cents)  mag {p.magnitude:.2f}")
        shown += 1
        if shown >= args.frames:
            break


if __name__ == "__main__":
    main()
