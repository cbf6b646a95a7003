"""Multi-host runtime: the cross-host communication backend.

The reference has NO distributed backend (SURVEY.md §5 — pthreads/OpenMP
only). This module is the jax.distributed glue for running fftlab across
several hosts: each host calls `initialize()` (standard JAX multi-host
contract), then every `dist/` collective pipeline works unchanged over a
mesh that spans the devices of all processes.

Single-host (including this environment) is a no-op fast path, so all
code can call `ensure_initialized()` unconditionally.
"""

from __future__ import annotations

import os

import jax

_INITIALIZED = False


def ensure_initialized(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process; no-op for
    single-host. Returns True if the distributed runtime is active.

    Environment-driven (standard JAX vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) or explicit arguments.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1")
    )
    if addr is None or nproc <= 1:
        return False  # single host; nothing to do
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    _INITIALIZED = True
    return True


def host_local_mesh_axes() -> dict:
    """Recommended axis layout across hosts: the halo-exchange axis
    ('sp') over the devices of one host, DP across hosts (the
    cross-host link carries only independent batch splits;
    SURVEY.md §2.2)."""
    n_local = jax.local_device_count()
    n_total = jax.device_count()
    hosts = max(n_total // max(n_local, 1), 1)
    return {"dp": hosts, "sp": n_local}


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }
