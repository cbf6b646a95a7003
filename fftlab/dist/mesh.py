"""Device mesh construction and sharding helpers.

This is the framework's "communication backend" — the replacement for
the reference's pthreads/OpenMP intra-node parallelism
(parallel_fft.c:130-210, fft_openmp.c:18-53) and for the inter-node
backend the reference never had (SURVEY.md §5). Collectives run over the
named axes of a `jax.sharding.Mesh` of devices; the mesh is shaped by the
algorithm, and the axis names used throughout the package are:

- ``"dp"``  batch / channel sharding (pure data parallel)
- ``"sp"``  sequence (time-block) sharding for overlap-save/STFT
- ``"tp"``  intra-transform sharding for the four-step FFT
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh_1d(axis_name: str = "x", devices=None) -> Mesh:
    """A 1D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh(shape: dict[str, int] | tuple, axis_names=None, devices=None) -> Mesh:
    """A named mesh, e.g. ``make_mesh({"dp": 2, "sp": 4})``."""
    if isinstance(shape, dict):
        axis_names = tuple(shape.keys())
        dims = tuple(shape.values())
    else:
        if axis_names is None:
            raise ValueError(
                "make_mesh with a tuple shape needs axis_names; or pass "
                'a dict like make_mesh({"dp": 2, "sp": 4})'
            )
        dims = tuple(shape)
        axis_names = tuple(axis_names)
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(dims))
    if n > len(devices):
        raise ValueError(f"mesh {dims} needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(dims), axis_names)


def shard_batch(x, mesh: Mesh, axis_name: str = "x", batch_axis: int = 0):
    """Place `x` with its batch axis sharded over `axis_name` (pure DP —
    the replacement for the reference's serial batched-GPU loop,
    fft_gpu.c:366-374)."""
    spec = [None] * x.ndim
    spec[batch_axis] = axis_name
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def replicate(x, mesh: Mesh):
    """Replicate `x` on every device of the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))
