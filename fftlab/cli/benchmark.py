"""Cross-algorithm benchmark table (benchmarks/benchmark_all.c analog).

Usage: python -m fftlab.cli.benchmark [--sizes 64,1024,16384] [--batch N]
       [--f64] [--algos radix2_dit,stockham_mxu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    from fftlab.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fftlab.bench.harness import (
        benchmark_suite,
        complexity_exponent,
        print_table,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", default="16,64,256,1024,4096,16384")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--f64", action="store_true",
                    help="complex128 (CPU oracle mode)")
    ap.add_argument("--algos", default=None)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the table as a JSON artifact "
                         "(benchmark_all.c:189-266 analog)")
    args = ap.parse_args()

    sizes = tuple(int(s) for s in args.sizes.split(","))
    algos = args.algos.split(",") if args.algos else None
    dtype = np.complex128 if args.f64 else np.complex64
    results = benchmark_suite(sizes, algos, args.batch, dtype)
    print(print_table(results))

    by_algo: dict[str, list] = {}
    for r in results:
        by_algo.setdefault(r.algorithm, []).append(r)
    exponents = {}
    print("\nempirical complexity exponents (benchmark_all.c:240-266):")
    for name, rs in by_algo.items():
        if len(rs) >= 3:
            exponents[name] = round(complexity_exponent(rs), 3)
            print(f"  {name:<16} t ~ n^{exponents[name]:.2f}")

    if args.json:
        import json
        import platform

        winners = {}
        for r in results:
            cur = winners.get(r.n)
            if cur is None or r.ms < cur[1]:
                winners[r.n] = (r.algorithm, r.ms)
        blob = {
            "metric": "cross_algorithm_table",
            "dtype": str(np.dtype(dtype)),
            "batch": args.batch,
            "host": platform.processor() or platform.machine(),
            "rows": [
                {"algorithm": r.algorithm, "n": r.n,
                 "ms": round(r.ms, 5),
                 "gsamples_per_s": r.gsamples_per_s,
                 "max_error": r.max_error,
                 "roundtrip_ok": r.roundtrip_ok}
                for r in results
            ],
            "winners_per_size": {str(n): {"algorithm": a,
                                          "ms": round(ms, 4)}
                                 for n, (a, ms) in sorted(winners.items())},
            "complexity_exponents": exponents,
        }
        with open(args.json, "w") as f:
            json.dump(blob, f, indent=1)
        print(f"\nartifact -> {args.json}")


if __name__ == "__main__":
    main()
