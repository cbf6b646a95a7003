"""Hardware capability detection.

The analog of the reference's CPUID-based `fft_detect_hardware`
(fft_auto.c:55-93, fft_auto.h:145-154): instead of SSE/AVX/NEON bits, we
report the JAX platform, device kind/count, per-device memory, and whether
a multi-device mesh is available — the inputs the planner actually uses.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class HardwareCaps:
    platform: str  # 'cpu' | 'gpu'
    device_kind: str
    num_devices: int
    num_local_devices: int
    memory_per_device_bytes: int | None
    supports_f64: bool
    has_mesh: bool  # >1 device → sharded plans possible

    def summary(self) -> str:
        mem = (
            f"{self.memory_per_device_bytes / 2**30:.1f} GiB"
            if self.memory_per_device_bytes
            else "unknown"
        )
        return (
            f"platform={self.platform} device={self.device_kind!r} "
            f"devices={self.num_devices} (local {self.num_local_devices}) "
            f"mem/device={mem} f64={self.supports_f64} mesh={self.has_mesh}"
        )


@functools.lru_cache(maxsize=1)
def detect_hardware() -> HardwareCaps:
    import jax

    devices = jax.devices()
    d0 = devices[0]
    try:
        stats = d0.memory_stats() or {}
        mem = stats.get("bytes_limit")
    except Exception:
        mem = None
    platform = d0.platform
    return HardwareCaps(
        platform=platform,
        device_kind=getattr(d0, "device_kind", platform),
        num_devices=len(devices),
        num_local_devices=len(jax.local_devices()),
        memory_per_device_bytes=mem,
        supports_f64=platform == "cpu",
        has_mesh=len(devices) > 1,
    )


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (one line per card), or "not available" where there is
    no nvidia-smi. A card set below its maximum power runs slower under
    load, so every device number is reported beside this line."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return r.stdout.strip() or "not available"


def print_hardware_info() -> None:
    """Demo printout (examples/demo_v2_features.c:202-222 analog)."""
    print(detect_hardware().summary())
