"""Every float32 contraction under a public transform entry states
Precision.HIGHEST.

On a GPU a dot or convolution without a stated precision may run in
TF32, which keeps a 10-bit mantissa and costs some 60 dB of SNR; the
library pins HIGHEST at each contraction instead of setting a global
default. This walks the jaxpr of each entry, sub-jaxprs included, and
checks every dot_general and conv_general_dilated. The one exception is
the filter operand of `lax.conv_general_dilated_patches`, a one-hot
matrix JAX builds itself and always marks DEFAULT: zeros and ones are
exact in every format, so only the signal operand's precision matters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HIGHEST = jax.lax.Precision.HIGHEST
CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _subjaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def contractions(jaxpr):
    """(primitive name, precision param) of every contraction, nested."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS:
            out.append((eqn.primitive.name, eqn.params.get("precision")))
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                out.extend(contractions(sub))
    return out


def _c64(n, batch=2):
    rng = np.random.default_rng(n)
    return jnp.asarray((rng.standard_normal((batch, n))
                        + 1j * rng.standard_normal((batch, n))
                        ).astype(np.complex64))


def _f32(*shape):
    return jnp.asarray(np.random.default_rng(7).standard_normal(shape)
                       .astype(np.float32))


def _entries():
    import fftlab
    from fftlab.algos import build_registry
    from fftlab.algos.dft import dft_bin
    from fftlab.algos.fft2d import fft2
    from fftlab.algos.real_fft import rfft
    from fftlab.algos.split_stockham import fft2_split
    from fftlab.core.framing import frame_signal_strided
    from fftlab.dsp.convolution import direct_convolution
    from fftlab.dsp.filtering import FilterParams, FilterType, fft_filter_split
    from fftlab.dsp.spectrum import welch_psd_split
    from fftlab.dsp.stft import stft_split
    from fftlab.plan.api import (
        plan_c2r_1d_split,
        plan_dft_1d_split,
        plan_r2c_1d_split,
    )
    from fftlab.plan.dispatch import fft_split_auto, spectral_filter_auto
    from fftlab.plan.filter_plan import FilterPlan

    reg = build_registry()
    h = np.random.default_rng(3).standard_normal(1024).astype(np.float32)
    lowpass = FilterParams(FilterType.LOWPASS, 0.1, sample_rate=1.0)
    return {
        "fft": (fftlab.fft, (_c64(4096),)),
        "ifft": (fftlab.ifft, (_c64(4096),)),
        "naive_dft": (reg["naive_dft"].fn, (_c64(256),)),
        "optimized_dft_real": (reg["optimized_dft"].fn, (_f32(2, 256),)),
        "optimized_dft_complex": (reg["optimized_dft"].fn, (_c64(256),)),
        "radix4": (reg["radix4"].fn, (_c64(1024),)),
        "mixed_radix_p7": (reg["mixed_radix"].fn, (_c64(7 * 11 * 4),)),
        "four_step": (reg["four_step"].fn, (_c64(4096),)),
        "dft_bin": (lambda x: dft_bin(x, 3), (_c64(256),)),
        "rfft": (rfft, (_f32(2, 4096),)),
        "fft2": (fft2, (_c64(64).reshape(2, 64),)),
        "fft_split_auto": (fft_split_auto, (_f32(2, 4096), _f32(2, 4096))),
        "fft_split_auto_prime": (fft_split_auto,
                                 (_f32(2, 10007), _f32(2, 10007))),
        "plan_dft_1d_split": (lambda a, b: plan_dft_1d_split(4096).execute(
            (a, b)), (_f32(2, 4096), _f32(2, 4096))),
        "plan_r2c_1d_split": (plan_r2c_1d_split(4096).execute,
                              (_f32(2, 4096),)),
        "plan_c2r_1d_split": (lambda a, b: plan_c2r_1d_split(4096).execute(
            (a, b)), (_f32(2, 2049), _f32(2, 2049))),
        "spectral_filter_auto": (
            lambda a, b: spectral_filter_auto(a, b, h, np.zeros_like(h)),
            (_f32(2, 1024), _f32(2, 1024))),
        "fft2_split": (fft2_split, (_f32(64, 128), _f32(64, 128))),
        "stft_split": (lambda x: stft_split(x, 256, 64), (_f32(4096),)),
        "welch_psd_split": (lambda x: welch_psd_split(x, 1.0, 256)[1],
                            (_f32(4096),)),
        "filter_plan": (FilterPlan(h[:33]), (_f32(8192),)),
        "fft_filter_split": (lambda a, b: fft_filter_split(a, b, lowpass),
                             (_f32(1024), _f32(1024))),
        "direct_convolution": (lambda x: direct_convolution(x, h[:33]),
                               (_f32(2, 512),)),
        "framing_patches": (lambda x: frame_signal_strided(x, 256, 64, 61),
                            (_f32(4096),)),
    }


ENTRIES = (
    "dft_bin", "direct_convolution", "fft", "fft2", "fft2_split",
    "fft_filter_split", "fft_split_auto", "fft_split_auto_prime",
    "filter_plan", "four_step", "framing_patches", "ifft",
    "mixed_radix_p7", "naive_dft", "optimized_dft_complex",
    "optimized_dft_real", "plan_c2r_1d_split", "plan_dft_1d_split",
    "plan_r2c_1d_split", "radix4", "rfft", "spectral_filter_auto",
    "stft_split", "welch_psd_split",
)


def test_entry_list_is_complete():
    assert sorted(ENTRIES) == sorted(_entries())


@pytest.mark.parametrize("name", ENTRIES)
def test_every_contraction_is_highest(name, monkeypatch):
    if name == "framing_patches":
        monkeypatch.setenv("FFTLAB_FRAMING", "patches")
    fn, args = _entries()[name]
    found = contractions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert found, f"{name}: no contraction traced"
    for prim, prec in found:
        assert prec is not None, f"{name}: {prim} without a precision"
        if prim == "conv_general_dilated" and name == "framing_patches":
            assert prec[0] == HIGHEST, (name, prim, prec)
        else:
            assert tuple(prec) == (HIGHEST, HIGHEST), (name, prim, prec)
