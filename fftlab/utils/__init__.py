"""Utilities: signal generation, metrics, plotting, file IO.

The analog of reference utils/fft_utils.c and the signal helpers in
include/fft_common.h:148-196.
"""

from fftlab.utils.signals import (
    generate_sine,
    generate_cosine,
    generate_square,
    generate_impulse,
    generate_dc,
    generate_chirp,
    generate_noise,
    generate_multi_tone,
)
from fftlab.utils.signals import zero_pad, frequency_shift
from fftlab.utils.io import (
    save_complex_signal,
    load_complex_signal,
    save_signal_npz,
    load_signal_npz,
    export_gnuplot_script,
)
from fftlab.utils.plotting import ascii_spectrum, ascii_image
from fftlab.utils.trace import Timer, span, profiler_trace
from fftlab.utils.compile_cache import enable_compile_cache
from fftlab.utils.metrics import (
    magnitude,
    phase,
    power_spectrum_bins,
    snr_db,
    max_error,
    rms_error,
    find_peak_interpolated,
)
