"""Native (C++) runtime components with ctypes bindings.

The reference is 100% native code; where the runtime around the device
compute path genuinely belongs on the host, this package provides the
C++ implementations (built from native/ at the repo root into
libfftlab_native.so):

- ``wav``   WAV audio file IO (the reference declares but never parses
            WAV, audio_spectrum.c:20-34)
- ``ring``  lock-free SPSC ring buffer — the streaming front-end
            (realtime_analyzer.c:58-93 circular buffer, done natively)
- ``q15``   Q15 block-floating-point FFT (optimizations/
            fixed_point_fft.c), the reduced-precision oracle
- ``fft64`` float64 host FFT backend — the dispatch vtable's second
            execution leg (fft_gpu.c:49-97 analog) and an independent
            correctness oracle

The library auto-builds with `make` on first use and caches; all
bindings raise a clear RuntimeError if no C++ toolchain is available.
"""

from fftlab.native.lib import load_native_lib, native_available
