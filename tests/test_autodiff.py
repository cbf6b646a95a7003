"""Differentiability: transforms must be usable under jax.grad (the
capability the C reference cannot have — learned spectral
filters, FFT layers in models)."""

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.algos.split_stockham import fft_split, spectral_filter_split_fused



class TestEinsumPathGrad:
    def test_grad_of_spectrum_energy(self):
        # d/dx sum|FFT(x)|^2 = 2*n*x by Parseval (real input, unscaled fwd).
        n = 256
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal(n))

        def energy(xr):
            yr, yi = fft_split(xr, jnp.zeros_like(xr))
            return jnp.sum(yr * yr + yi * yi)

        g = jax.grad(energy)(x)
        np.testing.assert_allclose(np.asarray(g), 2 * n * np.asarray(x),
                                   rtol=1e-6)

    def test_grad_through_fused_filter(self):
        n = 1024
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal(n), jnp.float32)
        h = jnp.asarray(rng.standard_normal(n), jnp.float32)

        def loss(hr):
            yr, yi = spectral_filter_split_fused(
                x, jnp.zeros_like(x), hr, jnp.zeros_like(hr)
            )
            return jnp.sum(yr * yr + yi * yi)

        g = jax.grad(loss)(h)
        assert g.shape == (n,) and bool(jnp.all(jnp.isfinite(g)))
        # Finite-difference check on one coordinate.
        eps = 1e-1
        fd = (float(loss(h.at[7].add(eps)))
              - float(loss(h.at[7].add(-eps)))) / (2 * eps)
        assert abs(fd - float(g[7])) < 5e-2 * max(abs(fd), 1.0)
