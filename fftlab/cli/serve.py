"""End-to-end serving demo: WAV in -> streamed FIR filter -> WAV out.

The full production chain: the native C++ WAV reader feeds the native
lock-free ring buffer; chunks drain through a FilterPlan stream (exact
continuity across chunks);
the filtered audio is written back as PCM16 WAV by the native writer.

Usage:
  python -m fftlab.cli.serve --in in.wav --out out.wav --type lowpass \
      --cutoff 2000 [--cutoff2 4000] [--taps 257] [--chunk 65536]

With no --in, a synthetic two-tone test file is generated and filtered
so the demo is self-contained.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.dsp.filtering import FilterParams, FilterType
    from fftlab.native.ring import RingBuffer
    from fftlab.native.wav import read_wav, write_wav
    from fftlab.plan.filter_plan import FilterPlan

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in", dest="inp", default=None)
    ap.add_argument("--out", dest="out", default=None)
    ap.add_argument("--type", default="lowpass",
                    choices=[t.value for t in FilterType if t.value != "custom"])
    ap.add_argument("--cutoff", type=float, default=2000.0)
    ap.add_argument("--cutoff2", type=float, default=0.0)
    ap.add_argument("--taps", type=int, default=257)
    ap.add_argument("--chunk", type=int, default=65536)
    args = ap.parse_args()

    if args.inp is None:
        # Self-contained: 440 Hz + 6 kHz two-tone at 16 kHz.
        fs = 16000
        t = np.arange(fs * 4) / fs
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)
               + 0.4 * np.sin(2 * np.pi * 6000 * t)).astype(np.float32)
        fd, args.inp = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        write_wav(args.inp, sig, fs)
        print(f"generated test input {args.inp} "
              f"(440 Hz + 6 kHz, {len(sig)/fs:.1f}s @ {fs} Hz)")
    if args.out is None:
        fd, args.out = tempfile.mkstemp(suffix=".filtered.wav")
        os.close(fd)

    audio, fs = read_wav(args.inp)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    params = FilterParams(
        FilterType(args.type), args.cutoff, args.cutoff2,
        sample_rate=float(fs), transition_width=args.cutoff * 0.1,
    )
    plan = FilterPlan(params, num_taps=args.taps)
    print(f"{plan.describe()}  fs={fs}  {args.type} @ {args.cutoff:g} Hz")

    # Producer -> ring -> consumer (streamed in chunks, exact continuity).
    ring = RingBuffer(max(args.chunk * 4, 1 << 18))
    out = np.empty(0, dtype=np.float32)
    t0 = time.perf_counter()
    pos = 0
    while pos < len(audio) or ring.available:
        if pos < len(audio):
            pos += ring.write(audio[pos : pos + args.chunk])
        chunk = ring.read(args.chunk)
        if len(chunk):
            out = np.concatenate([out, plan.stream(chunk)])
    dt = time.perf_counter() - t0
    write_wav(args.out, np.clip(out, -1, 1), fs)
    rate = len(audio) / dt / 1e6
    print(f"filtered {len(audio)} samples in {dt*1e3:.1f} ms "
          f"({rate:.1f} Msamples/s, {rate*1e6/fs:.0f}x realtime)")
    print(f"wrote {args.out}")

    # Spectral before/after summary.
    from fftlab.dsp.spectrum import welch_psd_split

    f1, p_in = welch_psd_split(audio[: 1 << 16], sample_rate=fs,
                               window_size=1024)
    _, p_out = welch_psd_split(out[: 1 << 16], sample_rate=fs,
                               window_size=1024)
    for tone in (440.0, 6000.0):
        k = int(tone * 1024 / fs)
        att = 10 * np.log10(
            max(float(p_out[k]), 1e-30) / max(float(p_in[k]), 1e-30)
        )
        print(f"  {tone:6.0f} Hz: {att:+7.1f} dB")


if __name__ == "__main__":
    main()
