"""2D FFT distributed over BOTH axes of a 2D device mesh.

`dist.fft2_sharded` (pencil decomposition) shards rows and runs each
1D pass locally — fine while a full row/column fits one device. This
module removes that limit: the image is BLOCK-sharded over a 2D mesh
(rows over one axis, columns over the other), and each 1D pass is
itself a four-step distributed transform (dist.four_step_split with
sharded batch dims):

    step 1  C-axis FFT of every row: rows stay sharded over `r_axis`
            as the batch; each row's transform distributes over
            `c_axis` (column FFTs + twiddle + all_to_all + row FFTs)
    step 2  R-axis FFT of every C-bin: bins stay sharded over `c_axis`
            as the batch; each bin's transform distributes over
            `r_axis`

No device ever holds more than its block; all collectives ride the
mesh axes. Split re/im planes throughout (complex-free).

Reference anchor: the row-column 2D decomposition image_fft.c:35-72
with BOTH loops replaced by the four-step of parallel_fft.c:213-272,
composed over a 2D mesh — the reference's single-core ancestor has no
analog of this.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fftlab.core.types import Direction, FORWARD
from fftlab.dist.four_step import split_n
from fftlab.dist.four_step_split import four_step_fft_sharded_split


def fft2_mesh2d_split(xr, xi, mesh: Mesh, r_axis: str = "a",
                      c_axis: str = "b", direction=FORWARD,
                      flatten: bool = True, r1: int | None = None,
                      c1: int | None = None):
    """2D FFT of [R, C] split planes with both axes distributed.

    `r_axis` shards the R dim (and distributes the R-axis transforms);
    `c_axis` shards the C-bins (and distributes the C-axis transforms).
    Inverse is 1/(R*C) scaled. `r1`/`c1` override the four-step
    factorizations R = r1*r2 / C = c1*c2 (default ~sqrt split) — pick
    them so the mesh axes divide the factors when the default split
    doesn't (e.g. non-pow2 axis sizes).

    flatten=True gathers and returns [R, C] pairs matching
    np.fft.fft2 (row index = R). flatten=False returns the
    [c1, c2, r1, r2] factor-matrix pair still sharded
    P(None, c_axis, None, r_axis) — spectrum bin (kR, kC) lives at
    [kC // c2, kC % c2, kR // r2, kR % r2] — for fused downstream
    pointwise stages without any replication gather.
    """
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(
            f"fft2_mesh2d_split expects matching [R, C] planes; got "
            f"{xr.shape} / {xi.shape}"
        )
    direction = Direction(int(direction))
    R, C = int(xr.shape[0]), int(xr.shape[1])
    pa = mesh.shape[r_axis]
    pc = mesh.shape[c_axis]
    r1, r2 = split_n(R, r1)
    c1, c2 = split_n(C, c1)
    # pa | r1 implies pa | R (the step-1 batch constraint); pc | c2
    # covers the step-2 batch constraint.
    if c1 % pc or c2 % pc:
        raise ValueError(
            f"mesh axis {c_axis}={pc} must divide both factors "
            f"({c1}, {c2}) of C={C} (override with c1=...)"
        )
    if r1 % pa or r2 % pa:
        raise ValueError(
            f"mesh axis {r_axis}={pa} must divide both factors "
            f"({r1}, {r2}) of R={R} (override with r1=...)"
        )

    # step 1: C-axis transform per row; R stays sharded as batch.
    yr, yi = four_step_fft_sharded_split(
        xr, xi, mesh, axis_name=c_axis, direction=direction, n1=c1,
        flatten=False, batch_axes=(r_axis,),
    )  # [R, c1, c2] P(r_axis, None, c_axis)

    # step 2: R-axis transform per C-bin; bins stay sharded as batch.
    zr = jnp.transpose(yr, (1, 2, 0))
    zi = jnp.transpose(yi, (1, 2, 0))
    wr, wi = four_step_fft_sharded_split(
        zr, zi, mesh, axis_name=r_axis, direction=direction, n1=r1,
        flatten=False, batch_axes=(None, c_axis),
    )  # [c1, c2, r1, r2] P(None, c_axis, None, r_axis)

    if not flatten:
        return wr, wi
    wr = jax.device_put(wr, NamedSharding(mesh, P()))
    wi = jax.device_put(wi, NamedSharding(mesh, P()))
    # (kC, kR) -> [R, C] with rows = kR (np.fft.fft2 orientation)
    wr = jnp.transpose(wr.reshape(C, R))
    wi = jnp.transpose(wi.reshape(C, R))
    return wr, wi
