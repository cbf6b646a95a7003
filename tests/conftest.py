"""Test configuration.

Tests run on CPU with 8 virtual XLA host devices (the multi-device "fake
backend" from SURVEY.md §4) and float64 enabled so the naive-DFT oracle is
a true float64 ground truth. The platform is the CPU unless JAX_PLATFORMS
names another (the `gpu`-marked tests need `JAX_PLATFORMS=cuda` on the
card); a process whose backend is already up keeps it.
"""

import os
import sys

# Tests must not see the developer/device wisdom file (route entries
# would leak measured state into dispatch assertions) — and must not
# WRITE to it either (tune_split_route persists cross-process now).
os.environ.setdefault("FFTLAB_NO_WISDOM_FILE", "1")
import tempfile  # noqa: E402

os.environ.setdefault(
    "FFTLAB_WISDOM_PATH",
    os.path.join(tempfile.gettempdir(), "fftlab_test_wisdom.json"),
)

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# fftlab installs editable via pyproject.toml (`pip install
# --no-build-isolation --no-deps -e .`); the path fallback only covers
# a fresh checkout that has not run the install yet.
try:
    import fftlab  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh8():
    """An 8-device 1D mesh over the virtual CPU devices."""
    return jax.make_mesh((8,), ("x",))
