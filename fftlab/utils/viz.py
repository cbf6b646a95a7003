"""Pedagogical visualizers: butterfly diagrams and memory-access traces.

Analogs of the reference's teaching aids:

- `butterfly_diagram(n)` — ASCII dataflow of the radix-2 DIT butterfly
  network (reference radix2_dit.c:147-173 prints the same picture with
  printf).
- `memory_access_trace(n)` — per-stage access-pattern table
  (iterative_fft.c:101-133 analog), annotated with stride vs a
  1024-element memory tile instead of a CPU cache line.
- `simulate_tile_touches(n)` — the toy cache simulator
  (iterative_fft.c:144-175) rebuilt for 1024-element tiles: counts how
  many distinct tiles each stage touches for DIT strided butterflies vs
  the Stockham matmul formulation, showing WHY the device path
  (algos/stockham.py) avoids the bit-reversal scatter entirely.

All host-side and O(n log n) string work — teaching tools, not compute
paths.
"""

from __future__ import annotations

from fftlab.core.types import is_power_of_two, log2_int

_TILE = 1024  # one toy memory tile: 1024 float32 (4 KB)


def butterfly_diagram(n: int) -> str:
    """ASCII butterfly network for an n-point radix-2 DIT FFT.

    One column per stage; each line is one signal index (bit-reversed
    input order, natural output order — radix2_dit.c:147-173 semantics).
    Practical for n <= 32.
    """
    if not is_power_of_two(n) or n < 2:
        raise ValueError(f"butterfly diagram requires power-of-two n >= 2, got {n}")
    if n > 32:
        raise ValueError("diagram is legible only for n <= 32 (use memory_access_trace)")
    stages = log2_int(n)
    # Bit-reversed input labels.
    rev = [0] * n
    for i in range(n):
        r = 0
        for b in range(stages):
            r |= ((i >> b) & 1) << (stages - 1 - b)
        rev[i] = r
    header = ["input(bitrev)"] + [f"stage {s+1} (m={1 << (s+1)})"
                                  for s in range(stages)] + ["output"]
    colw = max(len(h) for h in header) + 2
    lines = ["".join(h.ljust(colw) for h in header)]
    for i in range(n):
        cells = [f"x[{rev[i]}]"]
        for s in range(stages):
            m = 1 << (s + 1)
            half = m // 2
            j = i % m
            if j < half:
                # top of butterfly: partner below at distance half
                cells.append(f"+--({i},{i + half})")
            else:
                k = j - half
                cells.append(f"`-W_{m}^{k}-")
            # annotate twiddle exponent for the bottom leg only
        cells.append(f"X[{i}]")
        lines.append("".join(c.ljust(colw) for c in cells))
    lines.append(
        f"\n{stages} stages x {n // 2} butterflies; each butterfly: "
        "t = w*b; (a, b) <- (a + t, a - t)   [radix2_dit.c:104-106]"
    )
    return "\n".join(lines)


def memory_access_trace(n: int) -> str:
    """Per-stage butterfly access-pattern table with tile annotations.

    The reference's visualizer (iterative_fft.c:101-133) prints which
    indices each butterfly touches to show cache behavior. Here the
    unit is a 1024-element tile: strides below 1024 elements stay
    inside one tile, and the matmul formulation turns the whole stage
    into a contiguous contraction.
    """
    if not is_power_of_two(n):
        raise ValueError(f"requires power-of-two n, got {n}")
    stages = log2_int(n)
    lines = [
        f"memory access by stage, n={n} (DIT butterflies: pair stride = m/2)",
        f"{'stage':>5} {'m':>8} {'pair stride':>11} {'pattern':<24} tile view",
    ]
    for s in range(1, stages + 1):
        m = 1 << s
        half = m // 2
        if half < 128:
            view = "inside one 128-element row"
        elif half < _TILE:
            view = "crosses rows, same tile"
        else:
            view = f"crosses tiles (stride {half // _TILE} tiles)"
        first = f"(0,{half}) (1,{1 + half}) ..."
        lines.append(f"{s:>5} {m:>8} {half:>11} {first:<24} {view}")
    lines.append(
        "\nthe scatter-free alternative: Stockham regroups each stage as a\n"
        "dense [batch, r] x [r, r] matmul (algos/stockham.py) so every\n"
        "access is contiguous and the bit-reversal never materializes."
    )
    return "\n".join(lines)


def simulate_tile_touches(n: int) -> dict:
    """Tile touch counts: DIT strided butterflies vs Stockham stage.

    Toy model (iterative_fft.c:144-175 analog, cache line -> tile):
    for each DIT stage, count distinct float32 tiles touched per
    butterfly pair, summed over the stage; Stockham touches each tile
    exactly once per stage (contiguous matmul).  Returns the totals and
    the ratio — the quantitative version of "why Stockham".
    """
    if not is_power_of_two(n):
        raise ValueError(f"requires power-of-two n, got {n}")
    stages = log2_int(n)
    tiles = max(n // _TILE, 1)
    dit_touches = 0
    for s in range(1, stages + 1):
        half = 1 << (s - 1)
        if n <= _TILE:
            dit_touches += 1
            continue
        if half >= _TILE:
            # each pair touches two distinct tiles; every tile is hit
            # from butterflies of two separated regions
            dit_touches += 2 * tiles
        else:
            dit_touches += tiles
    stockham_touches = stages * tiles
    return {
        "n": n,
        "tiles": tiles,
        "dit_tile_touches": dit_touches,
        "stockham_tile_touches": stockham_touches,
        "ratio": dit_touches / stockham_touches,
    }
