"""v2 feature tour: auto-selection, plan API, hardware caps.

Analog of examples/demo_v2_features.c: auto-selection over
{64, 256, 1024, 4096, 16384, 97, 360, 1000} (:54-92) and the
hardware-capability printout (:202-222).
"""

from __future__ import annotations

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from fftlab import fft, plan_dft_1d
    from fftlab.plan.hardware import print_hardware_info
    from fftlab.plan.planner import estimate_algorithm, reference_heuristic
    from fftlab.plan.flags import PlanConfig
    from fftlab.utils.signals import generate_complex_noise

    print("=== fftlab v2 feature tour ===\n")
    print_hardware_info()

    print("\nAuto-selection (demo_v2_features.c:54-92 sizes):")
    cfg = PlanConfig()
    for n in (64, 256, 1024, 4096, 16384, 97, 360, 1000):
        algo = estimate_algorithm(n, cfg)
        ref = reference_heuristic(n)
        x = generate_complex_noise(n)
        X = fft(x)
        err = float(np.max(np.abs(np.asarray(X) - np.fft.fft(x))))
        print(f"  n={n:<7} fftlab->{algo:<14} (C reference would pick "
              f"{ref:<12}) max err vs numpy: {err:.2e}")

    print("\nPlan API (plan once, execute many):")
    plan = plan_dft_1d(1024)
    print(f"  {plan.describe()}")
    x = generate_complex_noise(1024, batch=(4,))
    X = plan.execute(np.asarray(x, dtype=np.complex64))
    print(f"  executed batch {x.shape} -> {X.shape} on "
          f"{jax.devices()[0].platform}")

    print("\nDevice-native split plan (route pinned at plan time):")
    from fftlab.plan.api import plan_dft_1d_split

    sp = plan_dft_1d_split(1 << 16)
    print(f"  {sp.describe()}")
    xr = np.asarray(np.real(x), np.float32)
    xi = np.asarray(np.imag(x), np.float32)
    sp1k = plan_dft_1d_split(1024)
    Yr, Yi = sp1k.execute((xr, xi))
    print(f"  executed split batch {xr.shape} via route "
          f"'{sp1k.algorithm}'; Flags.MEASURE would time every route "
          f"on-device and persist the winner as wisdom")

    from fftlab.plan.api import plan_c2r_1d_split, plan_r2c_1d_split

    pr = plan_r2c_1d_split(1 << 16)
    pc = plan_c2r_1d_split(1 << 16)
    print(f"  real plans (pack-two-reals through the same routes): "
          f"{pr.algorithm} / {pc.algorithm}")

    from fftlab.utils.viz import (
        butterfly_diagram,
        memory_access_trace,
        simulate_tile_touches,
    )
    from fftlab.algos.recursive import print_recursion_tree

    print("\nButterfly diagram, n=8 (radix2_dit.c:147-173 analog):")
    print(butterfly_diagram(8))
    print("\nRecursion tree, n=16 (recursive_fft.c:74-91 analog):")
    print_recursion_tree(16)
    print("\nMemory access by stage (iterative_fft.c:101-133 analog):")
    print(memory_access_trace(1 << 14))
    t = simulate_tile_touches(1 << 20)
    print(f"\ntile touch model at n=2^20: DIT {t['dit_tile_touches']} "
          f"vs Stockham {t['stockham_tile_touches']} "
          f"({t['ratio']:.2f}x) — why the device path is Stockham")


if __name__ == "__main__":
    main()
