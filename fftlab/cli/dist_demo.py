"""Multi-device demo: the full sharded pipeline on a virtual mesh.

Runs the DP x SP overlap-save filterbank, the TP four-step FFT, the
segment-sharded Welch PSD, and the frame-sharded STFT on however many
devices are available (use
XLA_FLAGS=--xla_force_host_platform_device_count=8 for 8 virtual CPU
devices), checking each against its single-device counterpart.
"""

from __future__ import annotations

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from fftlab.dist.four_step import four_step_fft, four_step_fft_sharded
    from fftlab.dist.mesh import make_mesh, make_mesh_1d
    from fftlab.dist.overlap_save import overlap_save_filterbank_sharded
    from fftlab.dist.welch import welch_psd_sharded
    from fftlab.dsp.convolution import fft_convolution
    from fftlab.dsp.spectrum import welch_psd

    devs = jax.devices()
    p = len(devs)
    print(f"{p} device(s): {devs[0].platform}")
    rng = np.random.default_rng(0)

    if p >= 2:
        dp = 2 if p % 2 == 0 else 1
        sp = p // dp
        mesh = make_mesh({"dp": dp, "sp": sp})
        c, n, nh = 2 * dp, 1024 * sp, 33
        x = rng.standard_normal((c, n))
        hb = rng.standard_normal((c, nh))
        y = np.asarray(overlap_save_filterbank_sharded(x, hb, mesh))
        err = max(
            float(np.max(np.abs(
                y[ch] - np.asarray(fft_convolution(x[ch], hb[ch]))[:n]
            ))) for ch in range(c)
        )
        print(f"overlap-save filterbank on (dp={dp}, sp={sp}): "
              f"{c} channels x {n} samples, max err {err:.2e}")

        mesh1 = make_mesh_1d("tp")
        m = 16 * p
        big = rng.standard_normal(m * m) + 1j * rng.standard_normal(m * m)
        X = np.asarray(four_step_fft_sharded(big, mesh1, "tp", n1=m))
        err = float(np.max(np.abs(X - np.asarray(four_step_fft(big)))))
        print(f"four-step {m*m}-pt FFT over tp={p} (all_to_all): "
              f"max err vs single-device {err:.2e}")

        sig = rng.standard_normal(2048 * p)
        _, psd_s = welch_psd_sharded(sig, mesh1, "tp", window_size=256)
        _, psd_1 = welch_psd(sig, window_size=256)
        err = float(np.max(np.abs(np.asarray(psd_s) - np.asarray(psd_1))))
        print(f"sharded Welch PSD (psum averaging): max err {err:.2e}")

        # 2D image FFT block-sharded over the SAME 2D mesh, both axes
        # distributed (each 1D pass a four-step over its mesh axis).
        if dp > 1:
            from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split

            R2, C2 = 16 * dp, 32 * sp * sp
            img = rng.standard_normal((R2, C2)).astype(np.float32)
            fr, fi = fft2_mesh2d_split(img, np.zeros_like(img), mesh,
                                       "dp", "sp", r1=4 * dp, c1=4 * sp)
            got = (np.asarray(fr, np.float64)
                   + 1j * np.asarray(fi, np.float64))
            err = float(np.max(np.abs(got - np.fft.fft2(img))))
            print(f"2D-mesh 2D FFT ({R2}x{C2} over dp x sp, both axes "
                  f"four-step): max err vs numpy {err:.2e}")

        # PP: stage-pipelined streaming sandwich (window/FFT/xH/IFFT
        # each on its own device, blocks flowing via ppermute).
        from fftlab.algos.split_stockham import spectral_filter_split
        from fftlab.dist.pp_pipeline import pp_spectral_pipeline_split

        pp = 4 if p >= 4 else 2
        mesh_pp = make_mesh({"pp": pp}, devices=devs[:pp])
        B, nb = 8, 512
        br = rng.standard_normal((B, nb)).astype(np.float32)
        hr = rng.standard_normal(nb).astype(np.float32)
        zi = np.zeros(nb, np.float32)
        yr, _ = pp_spectral_pipeline_split(
            br, np.zeros_like(br), hr, zi, mesh_pp, "pp")
        wr, _ = spectral_filter_split(
            jnp.asarray(br), jnp.zeros_like(jnp.asarray(br)),
            jnp.asarray(hr), jnp.asarray(zi))
        err = float(np.max(np.abs(np.asarray(yr) - np.asarray(wr))))
        print(f"PP pipeline ({pp} stages, {B} blocks, {B + pp - 1} "
              f"ticks): max err vs unsharded {err:.2e}")
    else:
        print("single device — sharded pipelines need >= 2 "
              "(set --xla_force_host_platform_device_count)")


if __name__ == "__main__":
    main()
