"""Public plan/execute API.

The analog of the reference v2 API (include/fft_auto.h:43-194,
algorithms/auto/fft_auto.c): `fft_auto` one-shot, plan create/execute/
destroy, r2c/c2r/2D plans — with every reference stub or bug implemented
correctly:

- r2c plans work (the reference's has a use-after-free, fft_auto.c:391-403);
- c2r plans work (reference returns NULL, fft_auto.c:405-408);
- 2D plans work (reference returns NULL, fft_auto.c:411-415);
- executors actually use the precomputed tables (the reference precomputes
  twiddles/bit-reverse tables it never reads, fft_auto.c:199-212 vs 250-283);
- the plan's direction is respected everywhere (the reference GPU path
  hardcodes FORWARD, fft_gpu.c:252,258).

A Plan here is a frozen decomposition choice + a jitted callable; "destroy"
is garbage collection (kept as a no-op method for API parity). Plans are
cached per (kind, n, dtype, direction, config), which is the JAX-native
analog of FFTW plan reuse: the second call with the same signature hits the
XLA compilation cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from fftlab.core.types import Direction, FORWARD, INVERSE, complex_dtype_for
from fftlab.plan.flags import Flags, PlanConfig
from fftlab.plan.planner import select_algorithm


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable transform plan (opaque `struct fft_plan` analog,
    fft_auto.c:19-47)."""

    kind: str  # 'c2c' | 'r2c' | 'c2r' | 'c2c_2d'
    n: Any  # int or (rows, cols)
    direction: Direction
    dtype: Any
    algorithm: str
    config: PlanConfig
    fn: Callable = dataclasses.field(compare=False)

    def execute(self, x):
        """fft_execute analog (fft_auto.c:241-283) — purely functional."""
        return self.fn(x)

    __call__ = execute

    def destroy(self) -> None:
        """fft_destroy_plan analog — a no-op; plans are immutable values."""

    def describe(self) -> str:
        return (
            f"Plan(kind={self.kind}, n={self.n}, dir={self.direction.name}, "
            f"algorithm={self.algorithm}, dtype={np.dtype(self.dtype).name})"
        )


def _registry():
    from fftlab.algos import build_registry

    return build_registry()


@functools.lru_cache(maxsize=256)
def _cached_plan(kind: str, n, direction: Direction, dtype_str: str,
                 config: PlanConfig) -> Plan:
    dtype = np.dtype(dtype_str)
    if kind == "c2c":
        algo = select_algorithm(n, direction, dtype, config)
        base = _registry()[algo].fn
        fn = jax.jit(functools.partial(base, direction=direction))
    elif kind == "r2c":
        from fftlab.algos.real_fft import rfft

        # The pack-two-reals path runs the inner complex transform at
        # n//2 for even n >= 4, at n otherwise — select for the size it
        # will actually run, and EXECUTE the selection (the reference
        # precomputes plan state its executors ignore, fft_auto.c:199-212
        # vs :250-283; we don't repeat that).
        inner_n = n // 2 if (n % 2 == 0 and n >= 4) else max(n, 1)
        inner = select_algorithm(inner_n, FORWARD, dtype, config)
        algo = f"rfft[{inner}]"
        fn = jax.jit(functools.partial(rfft, cfft=_registry()[inner].fn))
    elif kind == "c2r":
        from fftlab.algos.real_fft import irfft

        inner_n = n // 2 if (n % 2 == 0 and n >= 4) else max(n, 1)
        inner = select_algorithm(inner_n, INVERSE, dtype, config)
        algo = f"irfft[{inner}]"
        fn = jax.jit(functools.partial(irfft, n=n,
                                       cfft=_registry()[inner].fn))
    elif kind == "c2c_2d":
        from fftlab.algos.fft2d import fft2

        rows, cols = n
        a_rows = select_algorithm(rows, direction, dtype, config)
        a_cols = select_algorithm(cols, direction, dtype, config)
        algo = f"{a_rows}x{a_cols}"
        f_rows = _registry()[a_rows].fn
        f_cols = _registry()[a_cols].fn

        def _cfft_2d(x, d):
            # fft2 transforms the last axis twice with a transpose in
            # between; the axis length says which pass this is.
            return f_cols(x, d) if int(x.shape[-1]) == cols else f_rows(x, d)

        fn = jax.jit(functools.partial(fft2, direction=direction,
                                       cfft=_cfft_2d))
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    return Plan(kind, n, direction, dtype, algo, config, fn)


def plan_dft_1d(n: int, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
                dtype=np.complex64, config: PlanConfig | None = None) -> Plan:
    """fft_plan_dft_1d analog (fft_auto.h:43, fft_auto.c:175-238)."""
    config = config or PlanConfig(flags=flags)
    return _cached_plan("c2c", int(n), Direction(int(direction)), np.dtype(dtype).str, config)


def plan_r2c_1d(n: int, flags: Flags = Flags.ESTIMATE, dtype=np.float32,
                config: PlanConfig | None = None) -> Plan:
    """Working real-to-complex plan (fixes fft_auto.c:391-403)."""
    config = config or PlanConfig(flags=flags)
    return _cached_plan("r2c", int(n), FORWARD, np.dtype(dtype).str, config)


def plan_c2r_1d(n: int, flags: Flags = Flags.ESTIMATE, dtype=np.complex64,
                config: PlanConfig | None = None) -> Plan:
    """Working complex-to-real plan (fixes fft_auto.c:405-408)."""
    config = config or PlanConfig(flags=flags)
    return _cached_plan("c2r", int(n), INVERSE, np.dtype(dtype).str, config)


def plan_dft_2d(rows: int, cols: int, direction=FORWARD,
                flags: Flags = Flags.ESTIMATE, dtype=np.complex64,
                config: PlanConfig | None = None) -> Plan:
    """Working 2D plan (fixes fft_auto.c:411-415)."""
    config = config or PlanConfig(flags=flags)
    return _cached_plan(
        "c2c_2d", (int(rows), int(cols)), Direction(int(direction)),
        np.dtype(dtype).str, config,
    )


def plan_dft_1d_split(n: int, direction=FORWARD,
                      flags: Flags = Flags.ESTIMATE,
                      batch: int = 1) -> Plan:
    """Device-native plan for split re/im float32 planes — the
    counterpart of `plan_dft_1d` for callers that keep real and
    imaginary parts in separate arrays.

    Flag semantics (fft_auto.h:17-29 analogs, realized at the DISPATCH
    level):
      ESTIMATE     the dispatch route with the recorded (or default)
                   contraction leaf
      MEASURE/PATIENT/EXHAUSTIVE
                   time the candidate leaves for (n, batch) on this
                   device (plan.split_tuning.tune_split_leaf) unless a
                   measurement is already recorded; it persists as
                   wisdom
      WISDOM_ONLY  require a previously measured leaf (RuntimeError
                   otherwise — fft_auto semantics)

    The returned Plan's execute takes and returns an (re, im) pair.
    """
    from fftlab.plan.dispatch import run_route

    n = int(n)
    direction = Direction(int(direction))
    route = _split_route_for(n, flags, batch)

    def fn(pair):
        xr, xi = pair
        return run_route(route, xr, xi, direction)

    return Plan("c2c_split", n, direction, np.float32, route,
                PlanConfig(flags=flags), fn)


def _split_route_for(n: int, flags: Flags, batch: int) -> str:
    """Route selection shared by the split plan constructors:
    MEASURE-class flags (tune the leaf + persist) > WISDOM_ONLY > the
    ESTIMATE capability heuristic."""
    from fftlab.plan import wisdom
    from fftlab.plan.dispatch import select_split_impl
    from fftlab.plan.split_tuning import tune_split_leaf

    measured = wisdom.lookup(n, "f32", kind="split") is not None
    if flags & (Flags.MEASURE | Flags.PATIENT | Flags.EXHAUSTIVE):
        if not measured:
            tune_split_leaf(n, batch=batch)
    elif flags & Flags.WISDOM_ONLY and not measured:
        raise RuntimeError(
            f"WISDOM_ONLY set but no measured leaf wisdom for n={n}"
        )
    return select_split_impl(n, batch)


def _split_route_for_half(n: int, flags: Flags, batch: int) -> str:
    """Route for the HALF-size transform inside an r2c/c2r plan, with
    errors naming the half size: a bare 'no wisdom for n//2' would send
    the user off to MEASURE the full n, which cannot help."""
    try:
        return _split_route_for(n // 2, flags, batch)
    except RuntimeError as e:
        raise RuntimeError(
            f"{e} (the r2c/c2r plan for n={n} runs a HALF-size complex "
            f"transform: measure n={n // 2}, e.g. "
            f"plan_dft_1d_split({n // 2}, flags=Flags.MEASURE))"
        ) from None


def plan_r2c_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1) -> Plan:
    """Device-native real-to-complex plan: real [..., n] float32 in,
    one-sided (re, im) pair of n//2+1 bins out. The half-size complex
    transform (pack-two-reals trick) runs through the dispatch route for
    n//2. The working r2c the reference's plan layer never shipped
    (fft_auto.c:391-403 use-after-free), device-native."""
    from fftlab.algos.split_stockham import rfft_split
    from fftlab.plan.dispatch import run_route

    n = int(n)
    if n % 2 or n < 4:
        route = "einsum"  # rfft_split's odd-n fallback is einsum-based
        fn = lambda x: rfft_split(x)
    else:
        route = _split_route_for_half(n, flags, batch)
        cfft = lambda a, b: run_route(route, a, b, FORWARD)
        fn = lambda x: rfft_split(x, cfft=cfft)
    return Plan("r2c_split", n, FORWARD, np.float32,
                f"rfft_split[{route}]", PlanConfig(flags=flags), fn)


def plan_c2r_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1) -> Plan:
    """Device-native complex-to-real plan: one-sided (re, im) pair of
    n//2+1 bins in, real [..., n] float32 out (1/n scaled). Inverse of
    `plan_r2c_1d_split`; the half-size inverse transform runs through
    the dispatch route for n//2. The c2r the reference declares and
    returns NULL for (fft_auto.c:405-408), device-native."""
    from fftlab.algos.split_stockham import irfft_split
    from fftlab.plan.dispatch import run_route

    n = int(n)
    if n % 2 or n < 4:
        route = "einsum"
        fn = lambda pair: irfft_split(pair[0], pair[1], n=n)
    else:
        route = _split_route_for_half(n, flags, batch)
        cfft = lambda a, b: run_route(route, a, b, INVERSE)
        fn = lambda pair: irfft_split(pair[0], pair[1], n=n, cfft=cfft)
    return Plan("c2r_split", n, INVERSE, np.float32,
                f"irfft_split[{route}]", PlanConfig(flags=flags), fn)


def plan_dft_1d_native(n: int, direction=FORWARD) -> Plan:
    """A plan that executes on the HOST-NATIVE C++ backend
    (native/fft64.cpp via fftlab.native.fft64) — the second execution
    leg of the dispatch story, the role the reference's planner gives
    its ALGO_GPU_* rows (fft_auto.c:220-229, 275-282). Differences from
    the reference's GPU leg, on purpose:

    - the plan's direction is honored (fft_gpu.c:252,258 hardcodes
      FORWARD);
    - the inverse is 1/n scaled (the cuFFT leg's scaling launch is
      commented out, fft_cuda.cu:175-182);
    - it is a real FFT backend (the Metal leg is an image-conversion op
      plus a CPU fallback, fft_metal.m:128-158, 257-268).

    Takes/returns numpy complex128 [..., n]; no JAX, no device. Raises
    RuntimeError at plan time if the C++ toolchain and a prebuilt .so
    are both unavailable, ValueError for non-pow2 n (arbitrary n rides
    the Python Bluestein layer, like every backend)."""
    from fftlab.core.types import is_power_of_two
    from fftlab.native.fft64 import fft64
    from fftlab.native.lib import load_native_lib

    n = int(n)
    if not is_power_of_two(n):
        raise ValueError(f"native backend supports pow2 n; got {n}")
    load_native_lib()  # fail at plan time, not execute time
    direction = Direction(int(direction))
    inv = direction == INVERSE

    def fn(x):
        x = np.asarray(x)
        if int(x.shape[-1]) != n:
            raise ValueError(f"plan is for n={n}; got {x.shape[-1]}")
        return fft64(x, inverse=inv)

    return Plan("c2c_native", n, direction, np.complex128,
                "native_fft64", PlanConfig(), fn)


def execute(plan: Plan, x):
    """fft_execute analog."""
    return plan.execute(x)


def fft_auto(x, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
             config: PlanConfig | None = None):
    """One-shot transform: plan (cached) + execute (fft_auto.c:325-333)."""
    x = jnp.asarray(x)
    dtype = complex_dtype_for(x.dtype)
    plan = plan_dft_1d(int(x.shape[-1]), direction, flags,
                       dtype=dtype, config=config)
    return plan.execute(x.astype(dtype))


def fft(x, direction=FORWARD, algorithm: str | None = None,
        flags: Flags = Flags.ESTIMATE):
    """Primary user entry point: FFT over the last axis of [..., n].

    `algorithm` forces a registry algorithm by name; default auto-selects
    (the flagship matmul path for any size whose prime factors fit the leaf).
    """
    config = PlanConfig(flags=flags, algorithm=algorithm)
    return fft_auto(x, direction, flags, config)


def ifft(x, algorithm: str | None = None, flags: Flags = Flags.ESTIMATE):
    """Inverse FFT with 1/n scaling."""
    return fft(x, INVERSE, algorithm, flags)


def plan_dft_1d_sharded(n: int, mesh, axis_name: str = "tp",
                        direction=FORWARD, n1: int | None = None) -> Plan:
    """A plan whose execution shards ONE transform across the mesh via
    the four-step decomposition (one all_to_all over the mesh axis).

    The successor of `fft_plan_with_nthreads` (fft_auto.c:342-349):
    where the reference sets an OpenMP thread count, here the parallel
    resource is a mesh axis of devices.
    """
    import functools as _ft

    from fftlab.dist.four_step import four_step_fft_sharded, split_n

    n = int(n)
    n1_, n2_ = split_n(n, n1)
    p = mesh.shape[axis_name]
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both factors "
            f"({n1_}, {n2_}) of n={n}"
        )
    fn = _ft.partial(four_step_fft_sharded, mesh=mesh, axis_name=axis_name,
                     direction=direction, n1=n1_)
    return Plan(
        kind="c2c_sharded", n=n, direction=Direction(int(direction)),
        dtype=np.complex64, algorithm=f"four_step[{axis_name}={p}]",
        config=PlanConfig(), fn=fn,
    )
