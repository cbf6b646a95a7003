"""Run fftlab's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py             # one card: phases 1-8, then the
                                     # tests marked `gpu`
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

Each phase calls the public entry points a user calls, at the sizes the
benchmark rows use, and compares the card's result with a float64 NumPy
reference computed on the host. It prints one line per check: the SNR,
the tolerance it must reach, and the median time of one call (fenced
with block_until_ready) beside the median time of `jnp.fft` (cuFFT) on
the same input where there is one.

Tolerances. Every path computes in float32 with its contractions at
Precision.HIGHEST, which lands near 130 dB against float64; a float32
contraction that slipped to TF32 (10-bit mantissa) lands near 60 dB. So
each check must reach SNR_DB = 100 dB, which catches a TF32 leak with
room on both sides. Bluestein multiplies by chirps whose phases grow as
k^2 and convolves at twice the length, which costs about 10 dB more
rounding, so it must reach BLUESTEIN_SNR_DB = 90 dB.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed. The script exits non-zero, and
prints no such line, when a phase fails, when JAX's first device is not
a GPU, or when the fftlab package beside this file is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SNR_DB = 100.0
BLUESTEIN_SNR_DB = 90.0
TIMING_REPS = 10
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase. FULL is what runs on the card;
    tests run the same phases at SMALL on the CPU."""

    batch: int = 16
    n: int = 1 << 20            # phases 1, 2, 4: 16 x 2^20 (128 MiB c64)
    n_single: int = 1 << 24     # phase 2: one large transform
    rfft_batch: int = 8
    rfft_n: int = 1 << 21       # phase 3
    prime: int = 500009         # phase 5 (prime; chirp-z)
    prime_batch: int = 4
    taps: int = 129             # phase 6
    filter_n: int = 1 << 23
    stream_chunks: int = 9
    stft_n: int = 1 << 22       # phase 7
    frame: int = 2048
    hop: int = 512
    welch_window: int = 2048
    image: int = 4096           # phase 8: image x image
    four_step_n: int = 1 << 28  # --chips 4
    four_step_chunks: int = 4
    sharded_filter_n: int = 1 << 25
    tp_n: int = 1 << 24


FULL = Sizes()
SMALL = Sizes(batch=2, n=1 << 10, n_single=1 << 14, rfft_batch=2,
              rfft_n=1 << 11, prime=1009, prime_batch=2, taps=33,
              filter_n=1 << 14, stream_chunks=9, stft_n=1 << 13,
              frame=256, hop=64, welch_window=256, image=64,
              four_step_n=1 << 12, four_step_chunks=2,
              sharded_filter_n=1 << 14, tp_n=1 << 12)


class PhaseFailed(AssertionError):
    """A check of a phase missed its tolerance."""


def snr_db(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    err = np.sum(np.abs(got - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def median_ms(fn, *args, reps: int = TIMING_REPS) -> float:
    """Median wall time of one call of an already compiled `fn`, each
    call fenced with block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


class Report:
    """Prints the checks of a phase; a check below its tolerance raises."""

    def __init__(self, timed: bool = True):
        self.timed = timed

    def check(self, name: str, got, want, tol: float = SNR_DB,
              fn=None, args=(), ref_fn=None, ref_args=()) -> float:
        snr = snr_db(got, want)
        line = f"  {name:<44} snr={snr:7.1f} dB  tol>={tol:.0f} dB"
        if self.timed and fn is not None:
            line += f"  fftlab={median_ms(fn, *args):9.3f} ms"
            if ref_fn is not None:
                line += f"  jnp.fft={median_ms(ref_fn, *ref_args):9.3f} ms"
        ok = snr >= tol
        line += "  ok" if ok else "  FAIL"
        print(line, flush=True)
        if not ok:
            raise PhaseFailed(f"{name}: {snr:.1f} dB < {tol} dB")
        return snr

    def note(self, text: str) -> None:
        print(f"  {text}", flush=True)


# -- helpers -----------------------------------------------------------------

def _rng(seed: int):
    return np.random.default_rng(seed)


def _c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(z):
    import jax.numpy as jnp

    return (jnp.asarray(np.ascontiguousarray(z.real), jnp.float32),
            jnp.asarray(np.ascontiguousarray(z.imag), jnp.float32))


def _join(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _on(platform_of, name):
    platforms = {d.platform for d in platform_of.devices()}
    if platforms != {name}:
        raise PhaseFailed(f"result lives on {platforms}, not {name}")


# -- phases (one card) -------------------------------------------------------

def phase_complex_api(s: Sizes, rep: Report) -> None:
    """1. fftlab.fft / fftlab.ifft / plan_dft_1d on complex64."""
    import jax
    import jax.numpy as jnp

    import fftlab

    z = _c64(_rng(1), (s.batch, s.n))
    x = jnp.asarray(z)
    want = np.fft.fft(z.astype(np.complex128), axis=-1)
    plan = fftlab.plan_dft_1d(s.n)
    rep.note(f"plan_dft_1d({s.n}): {plan.describe()} "
             f"on {jax.devices()[0].platform}")
    X = fftlab.fft(x)
    _on(X, jax.devices()[0].platform)
    ref = jax.jit(jnp.fft.fft)
    rep.check(f"fftlab.fft {s.batch}x{s.n}", X, want,
              fn=fftlab.fft, args=(x,), ref_fn=ref, ref_args=(x,))
    y = fftlab.ifft(X)
    rep.check(f"fftlab.ifft round trip {s.batch}x{s.n}", y, z,
              fn=fftlab.ifft, args=(X,), ref_fn=jax.jit(jnp.fft.ifft),
              ref_args=(X,))
    rep.check(f"plan_dft_1d({s.n}).execute", plan.execute(x), want,
              fn=plan.execute, args=(x,))


def phase_split_fft(s: Sizes, rep: Report) -> None:
    """2. fft_split_auto forward and inverse, and one large transform."""
    import jax
    import jax.numpy as jnp

    from fftlab import INVERSE, fft_split_auto

    z = _c64(_rng(2), (s.batch, s.n))
    xr, xi = _pair(z)
    xc = jnp.asarray(z)
    fwd = jax.jit(fft_split_auto)
    inv = jax.jit(lambda a, b: fft_split_auto(a, b, INVERSE))
    zc = z.astype(np.complex128)
    rep.check(f"fft_split_auto {s.batch}x{s.n}", _join(*fwd(xr, xi)),
              np.fft.fft(zc, axis=-1), fn=fwd, args=(xr, xi),
              ref_fn=jax.jit(jnp.fft.fft), ref_args=(xc,))
    rep.check(f"fft_split_auto inverse {s.batch}x{s.n}",
              _join(*inv(xr, xi)), np.fft.ifft(zc, axis=-1),
              fn=inv, args=(xr, xi), ref_fn=jax.jit(jnp.fft.ifft),
              ref_args=(xc,))
    z1 = _c64(_rng(3), (s.n_single,))
    ar, ai = _pair(z1)
    rep.check(f"fft_split_auto single {s.n_single}", _join(*fwd(ar, ai)),
              np.fft.fft(z1.astype(np.complex128)), fn=fwd, args=(ar, ai),
              ref_fn=jax.jit(jnp.fft.fft), ref_args=(jnp.asarray(z1),))


def phase_real(s: Sizes, rep: Report) -> None:
    """3. r2c / c2r split plans and their round trip."""
    import jax
    import jax.numpy as jnp

    from fftlab import plan_c2r_1d_split, plan_r2c_1d_split

    x = _f32(_rng(4), (s.rfft_batch, s.rfft_n))
    xd = jnp.asarray(x)
    r2c = plan_r2c_1d_split(s.rfft_n, batch=s.rfft_batch)
    c2r = plan_c2r_1d_split(s.rfft_n, batch=s.rfft_batch)
    fr = jax.jit(r2c.execute)
    fc = jax.jit(c2r.execute)
    Xr, Xi = fr(xd)
    rep.check(f"plan_r2c_1d_split {s.rfft_batch}x{s.rfft_n}", _join(Xr, Xi),
              np.fft.rfft(x.astype(np.float64), axis=-1), fn=fr, args=(xd,),
              ref_fn=jax.jit(jnp.fft.rfft), ref_args=(xd,))
    y = fc((Xr, Xi))
    rep.check(f"plan_c2r_1d_split round trip {s.rfft_batch}x{s.rfft_n}",
              y, x, fn=fc, args=((Xr, Xi),))


def phase_spectral_filter(s: Sizes, rep: Report) -> None:
    """4. The FFT -> H -> IFFT sandwich."""
    import jax
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import permute_response
    from fftlab.plan.dispatch import spectral_filter_auto

    rng = _rng(5)
    z = _c64(rng, (s.batch, s.n))
    H = _c64(rng, (s.n,))
    xr, xi = _pair(z)
    hr, hi = np.ascontiguousarray(H.real), np.ascontiguousarray(H.imag)
    perm = permute_response(hr, hi, s.n)
    fn = jax.jit(lambda a, b: spectral_filter_auto(a, b, hr, hi,
                                                   permuted=perm))
    want = np.fft.ifft(np.fft.fft(z.astype(np.complex128), axis=-1)
                       * H.astype(np.complex128), axis=-1)
    xc, Hc = jnp.asarray(z), jnp.asarray(H)
    ref = jax.jit(lambda a, h: jnp.fft.ifft(jnp.fft.fft(a) * h))
    rep.check(f"spectral_filter_auto {s.batch}x{s.n}", _join(*fn(xr, xi)),
              want, fn=fn, args=(xr, xi), ref_fn=ref, ref_args=(xc, Hc))


def phase_bluestein(s: Sizes, rep: Report) -> None:
    """5. A prime size (chirp-z), split path and complex API."""
    import jax
    import jax.numpy as jnp

    import fftlab
    from fftlab import fft_split_auto

    z = _c64(_rng(6), (s.prime_batch, s.prime))
    want = np.fft.fft(z.astype(np.complex128), axis=-1)
    xr, xi = _pair(z)
    fn = jax.jit(fft_split_auto)
    rep.check(f"fft_split_auto prime {s.prime_batch}x{s.prime}",
              _join(*fn(xr, xi)), want, tol=BLUESTEIN_SNR_DB,
              fn=fn, args=(xr, xi), ref_fn=jax.jit(jnp.fft.fft),
              ref_args=(jnp.asarray(z),))
    x = jnp.asarray(z)
    rep.check(f"fftlab.fft prime {s.prime_batch}x{s.prime}",
              fftlab.fft(x), want, tol=BLUESTEIN_SNR_DB,
              fn=fftlab.fft, args=(x,))


def phase_stream_filter(s: Sizes, rep: Report) -> None:
    """6. FilterPlan: whole-signal, packed-real and streaming paths."""
    import jax.numpy as jnp

    from fftlab import FilterPlan

    rng = _rng(7)
    h = (rng.standard_normal(s.taps) / s.taps).astype(np.float32)
    x = _f32(rng, (s.filter_n,))
    x2 = _f32(rng, (s.filter_n,))
    plan = FilterPlan(h)
    xd, x2d = jnp.asarray(x), jnp.asarray(x2)
    hd = h.astype(np.float64)
    want = np.convolve(x.astype(np.float64), hd)[: s.filter_n]
    want2 = np.convolve(x2.astype(np.float64), hd)[: s.filter_n]
    yr, yi = plan(xd, x2d)
    rep.check(f"FilterPlan whole signal {s.taps} taps x {s.filter_n}",
              _join(yr, yi), want + 1j * want2, fn=plan, args=(xd, x2d))
    packed = plan(xd)
    rep.check(f"FilterPlan packed real {s.taps} taps x {s.filter_n}",
              packed, want, fn=plan, args=(xd,))
    # Unequal chunks: cut points drawn at random, then sorted.
    cuts = np.sort(rng.choice(np.arange(1, s.filter_n),
                              s.stream_chunks - 1, replace=False))
    chunks = np.split(x, cuts)
    plan.reset()
    streamed = np.concatenate([plan.stream(c) for c in chunks])
    rep.note(f"stream chunk lengths {[len(c) for c in chunks]}")
    rep.check(f"FilterPlan.stream {len(chunks)} chunks vs float64",
              streamed, want)
    # Same blocks, other block boundaries: equal to float32 rounding.
    rep.check(f"FilterPlan.stream {len(chunks)} chunks vs whole signal",
              streamed, np.asarray(packed, np.float64))


def phase_stft_welch(s: Sizes, rep: Report) -> None:
    """7. stft_split and the Welch PSD."""
    import jax
    import jax.numpy as jnp

    from fftlab.core.window import get_window, power_gain
    from fftlab.dsp.spectrum import welch_psd_split
    from fftlab.dsp.stft import stft_split

    x = _f32(_rng(8), (s.stft_n,))
    xd = jnp.asarray(x)
    fn = jax.jit(lambda a: stft_split(a, s.frame, s.hop))
    Sr, Si = fn(xd)
    n_frames = int(Sr.shape[0])
    w = np.asarray(get_window("hann", s.frame), np.float64)
    xp = np.pad(x.astype(np.float64),
                (0, (n_frames - 1) * s.hop + s.frame - s.stft_n))
    frames = np.lib.stride_tricks.sliding_window_view(
        xp, s.frame)[:: s.hop][:n_frames]
    rep.check(f"stft_split {s.frame}/{s.hop} over {s.stft_n}",
              _join(Sr, Si), np.fft.rfft(frames * w, axis=-1),
              fn=fn, args=(xd,))

    win = s.welch_window
    hop = win // 2
    wf = jax.jit(lambda a: welch_psd_split(a, 1.0, win, 0.5)[1])
    psd = wf(xd)
    ww = np.asarray(get_window("hann", win), np.float64)
    segs = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), win)[::hop]
    p = np.abs(np.fft.rfft(segs * ww, axis=-1)) ** 2
    dbl = np.full(win // 2 + 1, 2.0)
    dbl[0] = dbl[-1] = 1.0
    want = p.mean(axis=0) * dbl / (win * power_gain(ww))
    rep.check(f"welch_psd_split window {win} over {s.stft_n}", psd, want,
              fn=wf, args=(xd,))


def phase_2d(s: Sizes, rep: Report) -> None:
    """8. fft2_split on an image."""
    import jax
    import jax.numpy as jnp

    from fftlab.algos.split_stockham import fft2_split

    z = _c64(_rng(9), (s.image, s.image))
    xr, xi = _pair(z)
    fn = jax.jit(fft2_split)
    rep.check(f"fft2_split {s.image}x{s.image}", _join(*fn(xr, xi)),
              np.fft.fft2(z.astype(np.complex128)), fn=fn, args=(xr, xi),
              ref_fn=jax.jit(jnp.fft.fft2), ref_args=(jnp.asarray(z),))


ONE_CARD_PHASES = (phase_complex_api, phase_split_fft, phase_real,
                   phase_spectral_filter, phase_bluestein,
                   phase_stream_filter, phase_stft_welch, phase_2d)


# -- phases (four cards) -----------------------------------------------------

def _check_quartered(name: str, arrays, devices, rep: Report) -> None:
    """Each array's shards must cover every device, one quarter each."""
    for a in arrays:
        got = {sh.device for sh in a.addressable_shards}
        if got != set(devices):
            raise PhaseFailed(f"{name}: output on {len(got)} devices, "
                              f"want {len(devices)}")
        sizes = {sh.data.nbytes for sh in a.addressable_shards}
        if sizes != {a.nbytes // len(devices)}:
            raise PhaseFailed(f"{name}: shard bytes {sorted(sizes)}, want "
                              f"{a.nbytes // len(devices)} on each device")
    rep.note(f"{name}: output sharded over {len(devices)} devices, "
             f"{arrays[0].nbytes // len(devices)} bytes each per array")


def _folded_bins(z: np.ndarray, m: int) -> np.ndarray:
    """Exact float64 spectrum bins X[k * n/m], k < m, of a length-n
    signal: folding the signal modulo m leaves an m-point DFT."""
    return np.fft.fft(z.astype(np.complex128).reshape(-1, m).sum(axis=0))


def phase_sharded_four_step(s: Sizes, rep: Report, mesh) -> None:
    """The four-step FFT over the mesh, complex and split planes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fftlab.dist.four_step import four_step_fft_sharded
    from fftlab.dist.four_step_split import four_step_fft_sharded_split
    from fftlab.plan.dispatch import fft_split_auto

    n = s.four_step_n
    devices = list(mesh.devices.flat)
    z = _c64(_rng(10), (n,))
    m = min(n, 1 << 20)
    want = _folded_bins(z, m)
    stride = n // m
    sharded = NamedSharding(mesh, P("tp"))
    x = jax.device_put(jnp.asarray(z), sharded)
    fs = jax.jit(lambda a: four_step_fft_sharded(a, mesh, "tp",
                                                 flatten=False))
    Y = fs(x)
    _check_quartered("four_step_fft_sharded", [Y], devices, rep)
    y4 = np.asarray(Y).reshape(n)
    rep.check(f"four_step_fft_sharded {n} (bins k*{stride}) vs float64",
              y4[::stride], want, fn=fs, args=(x,))

    # The same transform on one card.
    one = devices[0]
    xr1 = jax.device_put(jnp.asarray(np.ascontiguousarray(z.real)), one)
    xi1 = jax.device_put(jnp.asarray(np.ascontiguousarray(z.imag)), one)
    f1 = jax.jit(fft_split_auto)
    y1 = _join(*f1(xr1, xi1))
    rep.check(f"four_step_fft_sharded {n} vs one card", y4, y1,
              fn=f1, args=(xr1, xi1))

    xr = jax.device_put(xr1, sharded)
    xi = jax.device_put(xi1, sharded)
    fsp = jax.jit(lambda a, b: four_step_fft_sharded_split(
        a, b, mesh, "tp", flatten=False, chunks=s.four_step_chunks))
    Yr, Yi = fsp(xr, xi)
    _check_quartered("four_step_fft_sharded_split", [Yr, Yi], devices, rep)
    ys = _join(Yr, Yi).reshape(n)
    rep.check(f"four_step_fft_sharded_split chunks={s.four_step_chunks} "
              f"(bins k*{stride}) vs float64", ys[::stride], want,
              fn=fsp, args=(xr, xi))
    rep.check(f"four_step_fft_sharded_split {n} vs one card", ys, y1)


def phase_sharded_filter(s: Sizes, rep: Report, mesh) -> None:
    """The overlap-save FilterPlan over a signal sharded four ways."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fftlab import FilterPlan

    n = s.sharded_filter_n
    devices = list(mesh.devices.flat)
    rng = _rng(11)
    h = (rng.standard_normal(s.taps) / s.taps).astype(np.float32)
    x = _f32(rng, (n,))
    x2 = _f32(rng, (n,))
    sharded = NamedSharding(mesh, P("tp"))
    xd = jax.device_put(jnp.asarray(x), sharded)
    x2d = jax.device_put(jnp.asarray(x2), sharded)
    plan = FilterPlan(h, mesh=mesh, time_axis="tp")
    yr, yi = plan(xd, x2d)
    _check_quartered("FilterPlan(mesh)", [yr, yi], devices, rep)
    got = _join(yr, yi)
    # float64 reference on a slice that straddles the first shard edge.
    lo, hi = n // 4 - min(n // 8, 1 << 16), n // 4 + min(n // 8, 1 << 16)
    hd = h.astype(np.float64)
    seg = lambda a: np.convolve(  # noqa: E731
        a[lo - (s.taps - 1): hi].astype(np.float64), hd, "valid")
    rep.check(f"FilterPlan(mesh) {s.taps} taps x {n} [{lo}:{hi}] "
              "vs float64", got[lo:hi], seg(x) + 1j * seg(x2),
              fn=plan, args=(xd, x2d))
    one = devices[0]
    plan1 = FilterPlan(h)
    r1, i1 = plan1(jax.device_put(jnp.asarray(x), one),
                   jax.device_put(jnp.asarray(x2), one))
    rep.check(f"FilterPlan(mesh) {n} vs one card", got, _join(r1, i1))


def phase_tp_pipeline(s: Sizes, rep: Report, mesh) -> None:
    """The gather-free sharded FFT -> H -> IFFT pipeline."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fftlab.dist.tp_pipeline import tp_spectral_filter_split
    from fftlab.plan.dispatch import spectral_filter_auto

    n = s.tp_n
    devices = list(mesh.devices.flat)
    rng = _rng(12)
    z = _c64(rng, (n,))
    H = _c64(rng, (n,))
    hr, hi = np.ascontiguousarray(H.real), np.ascontiguousarray(H.imag)
    sharded = NamedSharding(mesh, P("tp"))
    xr, xi = (jax.device_put(a, sharded) for a in _pair(z))
    fn = jax.jit(lambda a, b: tp_spectral_filter_split(
        a, b, hr, hi, mesh, "tp"))
    Yr, Yi = fn(xr, xi)
    _check_quartered("tp_spectral_filter_split", [Yr, Yi], devices, rep)
    # The gather-free form is the [n2, n1] matrix of the INPUT layout.
    got = _join(Yr, Yi).reshape(n)
    want = np.fft.ifft(np.fft.fft(z.astype(np.complex128))
                       * H.astype(np.complex128))
    rep.check(f"tp_spectral_filter_split {n} vs float64", got, want,
              fn=fn, args=(xr, xi))
    one = devices[0]
    a1, b1 = (jax.device_put(a, one) for a in _pair(z))
    y1 = _join(*spectral_filter_auto(a1[None], b1[None], hr, hi))[0]
    rep.check(f"tp_spectral_filter_split {n} vs one card", got, y1)


FOUR_CARD_PHASES = (phase_sharded_four_step, phase_sharded_filter,
                    phase_tp_pipeline)


# -- main --------------------------------------------------------------------

def require_gpu() -> None:
    """Fail at once unless JAX's first device is a GPU: this script
    measures the card and never falls back to the CPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's first device is {platform!r}, "
                         "not a GPU")


def require_package() -> None:
    """Fail unless the fftlab package beside this file is importable."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import fftlab

    where = os.path.dirname(os.path.abspath(fftlab.__file__))
    if os.path.dirname(where) != HERE:
        raise SystemExit(f"chip_smoke: fftlab imported from {where}, "
                         f"not from {HERE}")


def result_line(devices) -> str:
    """The last line of a passing run."""
    d0 = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}})


def run_phases(phases, sizes: Sizes, *extra, timed: bool = True) -> list:
    """Run each phase; return the names of those that failed."""
    failed = []
    for phase in phases:
        print(f"{phase.__doc__.splitlines()[0]}", flush=True)
        t0 = time.perf_counter()
        try:
            phase(sizes, Report(timed), *extra)
        except Exception as e:  # every phase runs; the exit code reports
            print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(phase.__name__)
        print(f"  ({time.perf_counter() - t0:.1f} s with compilation)",
              flush=True)
    return failed


def run_gpu_tests() -> int:
    """The tests marked `gpu`, in this process (one process per card)."""
    import pytest

    return pytest.main([os.path.join(HERE, "tests"), "-q", "-m", "gpu",
                        "-p", "no:cacheprovider", "-p", "no:randomly"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths over four cards")
    args = ap.parse_args(argv)
    require_package()
    from fftlab.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    require_gpu()

    import jax

    from fftlab.plan.hardware import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(), flush=True)
    print(f"jax {jax.__version__} devices: {jax.devices()}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    t0 = time.perf_counter()
    if args.chips == 4:
        from fftlab.dist.mesh import make_mesh_1d

        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke: --chips 4 needs 4 devices, "
                             f"have {len(jax.devices())}")
        devices = jax.devices()[:4]
        mesh = make_mesh_1d("tp", devices=devices)
        failed = run_phases(FOUR_CARD_PHASES, FULL, mesh)
    else:
        devices = jax.devices()[:1]
        failed = run_phases(ONE_CARD_PHASES, FULL)
        if run_gpu_tests() != 0:
            failed.append("tests marked gpu")
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr, flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
