"""FilterPlan: plan-once streaming FIR filtering — the serving API.

The reference's streaming story is the realtime analyzer's hop loop
(realtime_analyzer.c:58-93) and a comment describing overlap-add
(convolution.c:284-290). This is the productionized version: build the
plan once (response spectrum, block size, optional mesh), then

- ``plan(x)``            filter whole signals (batched),
- ``plan.stream(chunk)`` filter an unbounded stream chunk by chunk with
                         exact continuity (the carried halo makes the
                         concatenated outputs IDENTICAL to filtering the
                         concatenated input), and
- a mesh-attached plan runs the sharded overlap-save (ppermute halo)
  across devices.

Everything under the hood is the split-plane path.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from fftlab.core.types import next_power_of_two


class FilterPlan:
    """A frozen FIR filtering plan.

    h: real taps [nh] (or a FilterParams to design a response-derived
    FIR via dsp.filtering.design_fir with `num_taps`).
    """

    def __init__(self, h, fft_size: int | None = None, mesh=None,
                 time_axis: str = "sp", num_taps: int = 129):
        from fftlab.dsp.filtering import FilterParams, design_fir

        if isinstance(h, FilterParams):
            h = design_fir(num_taps, h)
        self.h = np.asarray(h, dtype=np.float32)
        self.nh = int(self.h.shape[-1])
        if self.h.ndim != 1:
            raise ValueError(f"taps must be 1D, got {self.h.shape}")
        if fft_size is None:
            fft_size = max(next_power_of_two(4 * self.nh), 256)
        if fft_size < next_power_of_two(2 * self.nh):
            raise ValueError(
                f"fft_size {fft_size} too small for {self.nh} taps"
            )
        self.fft_size = int(fft_size)
        self.mesh = mesh
        self.time_axis = time_axis
        self._tail: np.ndarray | None = None

        from fftlab.algos.split_stockham import stockham_fft_split_unscaled
        from fftlab.core.types import Direction

        hp = jnp.asarray(np.pad(self.h, (0, self.fft_size - self.nh)))
        Hr, Hi = stockham_fft_split_unscaled(
            hp, jnp.zeros_like(hp), Direction.FORWARD
        )
        self._Hr = Hr
        self._Hi = Hi
        self._jit_blocks = jax.jit(self._filter_blocks)

    # -- core block math (split path) ------------------------------------

    def _filter_blocks(self, xr, xi):
        """Overlap-save on a halo-prefixed signal pair -> valid outputs."""
        from fftlab.algos.split_stockham import (
            _twiddle_split,
            stockham_fft_split_unscaled,
        )
        from fftlab.core.types import Direction

        from fftlab.core.framing import frame_signal_strided

        nh, fft_size = self.nh, self.fft_size
        hop = fft_size - (nh - 1)
        total = int(xr.shape[-1])
        valid = total - (nh - 1)
        n_blocks = -(-valid // hop)
        Fr, Fi = stockham_fft_split_unscaled(
            frame_signal_strided(xr, fft_size, hop, n_blocks),
            frame_signal_strided(xi, fft_size, hop, n_blocks),
            Direction.FORWARD,
        )
        Gr, Gi = _twiddle_split(Fr, Fi, self._Hr, self._Hi)
        yr, yi = stockham_fft_split_unscaled(Gr, Gi, Direction.INVERSE)
        s = 1.0 / fft_size
        yr = (yr * s)[..., nh - 1:]
        yi = (yi * s)[..., nh - 1:]
        shape = (*yr.shape[:-2], n_blocks * hop)
        return (yr.reshape(shape)[..., :valid],
                yi.reshape(shape)[..., :valid])

    # -- whole-signal execution ------------------------------------------

    def __call__(self, x, x_imag=None):
        """Filter [..., n]: returns the causal output (same length).

        Pass `x_imag` to filter a second real channel for free (real H
        is Hermitian), or a complex signal as split planes.
        """
        if self.mesh is not None:
            from fftlab.dist.overlap_save_split import (
                overlap_save_filter_sharded_split,
            )

            xr = jnp.asarray(x, dtype=jnp.float32)
            xi = (jnp.asarray(x_imag, dtype=jnp.float32)
                  if x_imag is not None else jnp.zeros_like(xr))
            yr, yi = overlap_save_filter_sharded_split(
                xr, xi, jnp.asarray(self.h), self.mesh, self.time_axis,
                self.fft_size,
            )
            return (yr, yi) if x_imag is not None else yr
        xr = jnp.asarray(x, dtype=jnp.float32)
        if x_imag is None and xr.ndim == 1:
            packed = self._call_packed_real(xr)
            if packed is not None:
                return packed
        xi = (jnp.asarray(x_imag, dtype=jnp.float32)
              if x_imag is not None else jnp.zeros_like(xr))
        pad = [(0, 0)] * (xr.ndim - 1) + [(self.nh - 1, 0)]
        yr, yi = self._jit_blocks(jnp.pad(xr, pad), jnp.pad(xi, pad))
        return (yr, yi) if x_imag is not None else yr

    def _call_packed_real(self, xr):
        """r2c fast path for one long real channel: pack the signal's two
        halves into the re/im planes so every complex FFT in the sandwich
        carries two half-signals — halving the transform work (the
        roadmap's "true rfft-based block path", exact by linearity:
        conv(a + i*b, h) = conv(a, h) + i*conv(b, h) for real h).

        The imag plane is prefixed with the first half's (nh-1)-sample
        tail so its causal history is exact; the stitched output equals
        the unpacked path bit-for-bit in exact arithmetic. Returns None
        when the signal is too short to be worth splitting."""
        n = int(xr.shape[-1])
        s = -(-n // 2)
        keep = self.nh - 1
        if s < max(2 * self.fft_size, keep + 1):
            return None
        a, b = xr[:s], xr[s:]
        T = s + keep
        ar = jnp.concatenate([a, jnp.zeros(T - s, xr.dtype)])
        ai = jnp.concatenate(
            [a[s - keep:], b, jnp.zeros(T - keep - (n - s), xr.dtype)]
        )
        pad = [(keep, 0)]
        yr, yi = self._jit_blocks(jnp.pad(ar, pad), jnp.pad(ai, pad))
        return jnp.concatenate([yr[:s], yi[keep:keep + (n - s)]])

    # -- streaming --------------------------------------------------------

    def stream(self, chunk) -> np.ndarray:
        """Filter the next chunk of an unbounded stream (1D real).

        Carries the (nh-1)-sample halo between calls so that
        concat(stream(c) for c) == plan(concat(c)) exactly.
        """
        c = np.asarray(chunk, dtype=np.float32)
        if c.ndim != 1:
            raise ValueError("stream() expects 1D chunks")
        if self._tail is None:
            self._tail = np.zeros(self.nh - 1, dtype=np.float32)
        buf = np.concatenate([self._tail, c])
        keep = self.nh - 1
        self._tail = buf[len(buf) - keep:] if keep else buf[:0]
        # jax.jit specializes on shape, so variable-size chunks would
        # trigger a recompile per distinct length — fatal for realtime
        # streaming. Zero-pad the buffer to a power-of-two block count
        # (output sample i only reads buf[i : i+nh], so padding at the
        # end never contaminates the first len(c) outputs we return);
        # compile count is then O(log max_chunk) for any chunk mix.
        hop = self.fft_size - keep
        n_blocks = max(-(-max(len(c), 1) // hop), 1)
        padded = keep + next_power_of_two(n_blocks) * hop
        zpad = np.zeros(padded - len(buf), dtype=np.float32)
        bufp = jnp.asarray(np.concatenate([buf, zpad]))
        yr, _ = self._jit_blocks(bufp, jnp.zeros(padded, jnp.float32))
        return np.asarray(yr)[: len(c)]

    def reset(self) -> None:
        """Forget streaming state (start a new stream)."""
        self._tail = None

    def describe(self) -> str:
        where = (f"mesh[{self.time_axis}]" if self.mesh is not None
                 else "single-device")
        return (f"FilterPlan(nh={self.nh}, fft_size={self.fft_size}, "
                f"hop={self.fft_size - self.nh + 1}, {where})")
