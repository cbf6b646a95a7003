"""Checks that only an NVIDIA GPU can answer. Each test skips elsewhere;
chip_smoke.py runs them on the card, or run them there with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; first device is {d.platform}")
    return d


def _snr(got, want):
    err = np.sum(np.abs(got - want) ** 2)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / err)


@pytest.mark.parametrize("strategy", ["gather", "patches", "slices"])
def test_framing_is_exact_on_card(card, monkeypatch, strategy):
    """Every framing strategy copies samples bit for bit on the card:
    `patches` is a convolution, exact only because it runs at HIGHEST."""
    import jax
    import jax.numpy as jnp

    from fftlab.core.framing import frame_signal_strided

    monkeypatch.setenv("FFTLAB_FRAMING", strategy)
    n, frame, hop = 1 << 20, 2048, 512
    n_frames = (n - frame) // hop + 1
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda a: frame_signal_strided(a, frame, hop, n_frames))(
            jnp.asarray(x)))
    want = np.lib.stride_tricks.sliding_window_view(x, frame)[::hop]
    np.testing.assert_array_equal(got, want)


def test_split_fft_keeps_float32_on_card(card):
    """The pinned HIGHEST precision keeps the split FFT near 130 dB; the
    same contraction in TF32 loses some 60 dB, so the two must differ."""
    from fftlab.algos.lowprec import snr_vs_oracle

    r = snr_vs_oracle(n=1 << 16, batch=2, modes=("f32", "tf32"))
    assert r["f32"] > 100.0, r
    assert r["tf32"] < 90.0, r


def test_complex_api_reaches_gate_on_card(card):
    import jax.numpy as jnp

    import fftlab

    rng = np.random.default_rng(1)
    z = (rng.standard_normal((4, 1 << 16))
         + 1j * rng.standard_normal((4, 1 << 16))).astype(np.complex64)
    X = fftlab.fft(jnp.asarray(z))
    assert {d.platform for d in X.devices()} == {"gpu"}
    assert _snr(np.asarray(X, np.complex128), np.fft.fft(z, axis=-1)) > 100.0
