"""fftlab — an FFT + spectral-DSP framework in JAX.

A from-scratch re-design (NOT a port) of the capabilities of the reference
C library `muditbhargava66/FFT-implementation-in-C`:

- 8 FFT algorithm families + 2 reference DFTs (reference: algorithms/),
  re-designed around matrix units: mixed-radix Cooley-Tukey where every
  stage is a batched matmul against a small DFT matrix with fused twiddles.
- An FFTW-style auto-selection / planning layer with flags, measurement
  ("wisdom"), aligned allocation semantics (reference: algorithms/auto/).
- DSP applications: filtering, convolution (incl. overlap-save/overlap-add),
  spectrum analysis, Welch PSD, 2D image FFT, pitch detection
  (reference: applications/, examples/).
- Distributed execution over a `jax.sharding.Mesh`: batch sharding (DP),
  four-step single-transform decomposition with `all_to_all` (TP), and
  overlap-save time-block sharding with `ppermute` halo exchange (SP)
  (reference's pthreads/OpenMP/four-step track: optimizations/parallel_fft.c).

Everything is batch-first: transforms operate on the last axis of `[..., n]`
arrays and are jit/vmap/shard_map friendly.
"""

from fftlab.core.types import Direction, FORWARD, INVERSE
from fftlab.plan.filter_plan import FilterPlan
from fftlab.plan.api import (
    fft,
    ifft,
    fft_auto,
    plan_dft_1d,
    plan_dft_1d_split,
    plan_r2c_1d,
    plan_c2r_1d,
    plan_r2c_1d_split,
    plan_c2r_1d_split,
    plan_dft_2d,
    execute,
)
from fftlab.algos.real_fft import rfft, irfft
from fftlab.algos.fft2d import fft2, ifft2, fftshift, ifftshift
from fftlab.algos.split_stockham import (
    fft_split,
    ifft_split,
    rfft_split,
    irfft_split,
    spectral_filter_split,
    to_split,
    from_split,
)
from fftlab.plan.dispatch import fft_split_auto, select_split_impl

__version__ = "0.4.0"

__all__ = [
    "Direction",
    "FORWARD",
    "INVERSE",
    "fft",
    "ifft",
    "fft_auto",
    "plan_dft_1d",
    "plan_dft_1d_split",
    "plan_r2c_1d",
    "plan_c2r_1d",
    "plan_r2c_1d_split",
    "plan_c2r_1d_split",
    "plan_dft_2d",
    "execute",
    "rfft",
    "irfft",
    "fft2",
    "ifft2",
    "fftshift",
    "ifftshift",
    "fft_split",
    "ifft_split",
    "rfft_split",
    "irfft_split",
    "spectral_filter_split",
    "to_split",
    "from_split",
    "FilterPlan",
    "fft_split_auto",
    "select_split_impl",
]
