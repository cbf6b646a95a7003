"""DSP applications built on the plan API.

The analog of the reference's applications/ layer: filtering,
convolution, spectrum analysis (periodogram/Welch/correlation/coherence),
STFT, 2D image processing, pitch detection, streaming analysis.
"""

from fftlab.dsp.filtering import FilterType, FilterParams, fft_filter, design_fir
from fftlab.dsp.convolution import (
    direct_convolution,
    fft_convolution,
    circular_convolution,
    overlap_save,
    overlap_add,
    convolve2d,
)
from fftlab.dsp.spectrum import (
    periodogram,
    welch_psd,
    welch_psd_split,
    autocorrelation,
    autocorrelation_split,
    cross_correlation,
    cross_correlation_split,
    coherence,
    coherence_split,
    spectral_stats,
)
from fftlab.dsp.stft import stft, istft, istft_split, spectrogram, stft_split
from fftlab.dsp.analyzer import (
    analyze_spectrum,
    analyze_peaks,
    find_peaks,
    RealtimeAnalyzer,
    AnalyzerConfig,
)
from fftlab.dsp.pitch import (
    detect_pitch,
    pitch_spectral_peak,
    harmonic_product_spectrum,
    pitch_autocorrelation,
    freq_to_note,
)
from fftlab.dsp.image import (
    lowpass_filter_image,
    highpass_filter_image,
    detect_edges,
    log_magnitude_spectrum,
)
