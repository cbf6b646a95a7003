"""Distributed execution over a `jax.sharding.Mesh`.

The reference is single-node (SURVEY.md §2.2: pthreads/OpenMP only,
no MPI/NCCL anywhere). This package is its multi-device re-design:

- ``mesh``         mesh construction + sharding helpers (the comm backend)
- ``four_step``    one large transform sharded across devices with an
                   ``all_to_all`` transpose (TP analog of the
                   reference four-step FFT, parallel_fft.c:213-272)
- ``overlap_save`` streaming FIR filtering with time-blocks sharded across
                   devices and ``ppermute`` halo exchange (SP/ring analog)
- ``welch``        Welch PSD with segments sharded and ``psum`` averaging
                   (DP analog of power_spectrum.c:88-130)
- ``stft``         frame-sharded STFT spectral pipelines
- ``tp_pipeline``  gather-free sharded FFT -> H -> IFFT (TP end to end)
- ``pp_pipeline``  stage-pipelined streaming sandwich: window/FFT/xH/IFFT
                   each on its own device, blocks flowing via ``ppermute``
                   (PP analog; the EP analog is ``overlap_save``'s
                   filterbank form — each channel shard applies its own
                   expert taps)
"""

from fftlab.dist.mesh import make_mesh_1d, shard_batch
from fftlab.dist.four_step import four_step_fft, four_step_fft_sharded
from fftlab.dist.four_step_split import four_step_fft_sharded_split
from fftlab.dist.fft2_sharded import fft2_sharded_split
from fftlab.dist.overlap_save import overlap_save_filter_sharded
from fftlab.dist.overlap_save_split import overlap_save_filter_sharded_split
from fftlab.dist.pp_pipeline import pp_spectral_pipeline_split
from fftlab.dist.tp_pipeline import tp_spectral_filter_split
from fftlab.dist.welch import welch_psd_sharded
from fftlab.dist.stft import stft_sharded

__all__ = [
    "make_mesh_1d",
    "shard_batch",
    "four_step_fft",
    "four_step_fft_sharded",
    "four_step_fft_sharded_split",
    "fft2_sharded_split",
    "overlap_save_filter_sharded_split",
    "overlap_save_filter_sharded",
    "pp_spectral_pipeline_split",
    "tp_spectral_filter_split",
    "welch_psd_sharded",
    "stft_sharded",
]
