"""Planning layer: FFTW-style auto-selection, flags, wisdom, hardware caps.

The analog of the reference's v2 public API
(algorithms/auto/fft_auto.c + include/fft_auto.h).
"""
