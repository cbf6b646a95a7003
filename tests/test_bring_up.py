"""What the move to the GPU left behind: the compile-cache helper, no
kernel tier, no option that picked one, and bench.py's one JSON line."""

import json
import os
import re
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- the compile cache --------------------------------------------------------


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_environment_stands(monkeypatch, restore_cache_dir):
    from fftlab.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    from fftlab.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_dir_is_fixed(monkeypatch, restore_cache_dir):
    from fftlab.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    import tempfile

    first = enable_compile_cache()
    assert enable_compile_cache() == first == os.path.join(ROOT, ".jax_cache")
    assert str(os.getpid()) not in first
    assert not first.startswith(tempfile.gettempdir())


# -- no kernel tier -----------------------------------------------------------


def test_import_loads_no_pallas():
    code = ("import sys, fftlab, fftlab.plan.dispatch, fftlab.dsp.stft, "
            "fftlab.plan.filter_plan; "
            "print([m for m in sys.modules if 'pallas' in m])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    assert r.stdout.strip() == "[]"


def test_routes_and_registry_name_no_kernel():
    from fftlab.algos import build_registry
    from fftlab.plan.dispatch import ROUTES, select_split_impl

    assert ROUTES == ("einsum",)
    assert all(select_split_impl(1 << k) == "einsum" for k in range(8, 28))
    for name in build_registry():
        assert "pallas" not in name and "vmem" not in name


def _sources():
    paths = [os.path.join(ROOT, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "fftlab")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return {p: open(p).read() for p in paths}


REMOVED = [
    # kernel modules, routes and entry points
    "fft_vmem", "resident_vmem", "fourstep_vmem", "threestep_vmem",
    "rfft_resident", "rfft_vmem", "stft_vmem", "os_filter_vmem",
    "stage_fused", "pallas_vmem", "pallas_pipeline", "resident_v4",
    "resident_v6", "resident_cio", "fft_split_large", "rfft_split_large",
    "irfft_split_large", "spectral_filter_large", "fft_split_huge",
    "kernels_enabled", "prefer_cpu_for_complex", "factory_wisdom",
    # the options that picked them
    "FFTLAB_FORCE_IMPL", "FFTLAB_NO_PALLAS", "FFTLAB_RESIDENT_FILTER",
    "FFTLAB_RFFT_FUSED", "FFTLAB_FS_", "FFTLAB_TS_", "FFTLAB_RES_",
    "FFTLAB_OS_", "FFTLAB_FSFILT_LANES", "FFTLAB_MXU_PRECISION",
    "FFTLAB_BENCH_",
    # the Pallas route itself, its interpreter and the CPU fallback
    "pallas", "mosaic", "interpret=", "jax_platforms",
]


@pytest.mark.parametrize("name", REMOVED)
def test_no_source_names_removed_kernel_or_option(name):
    hits = [os.path.relpath(p, ROOT) for p, s in _sources().items()
            if name.lower() in s.lower()]
    assert not hits, f"{name!r} still in {hits}"


def test_platform_branches_name_only_cpu_or_gpu():
    """Code may branch on the CPU or the GPU, and on no other platform."""
    compared = set()
    for s in _sources().values():
        compared |= set(re.findall(
            r"""(?:platform|backend\(\))\s*[!=]=\s*["'](\w+)["']""", s))
        compared |= set(re.findall(
            r"""["'](\w+)["']\s*[!=]=\s*\S*(?:platform|backend\(\))""", s))
    assert compared <= {"cpu", "gpu"}, compared


def test_only_deployment_knobs_remain():
    knobs = set()
    for s in _sources().values():
        knobs |= set(re.findall(r"FFTLAB_[A-Z0-9_]+", s))
    assert knobs <= {"FFTLAB_WISDOM_PATH", "FFTLAB_NO_WISDOM_FILE",
                     "FFTLAB_FRAMING"}, knobs


# -- bench.py -----------------------------------------------------------------


def test_bench_prints_one_line_with_device(capsys, monkeypatch):
    import importlib.util

    import fftlab.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "")
    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == {"platform": "cpu", "kind": "cpu",
                              "count": len(jax.devices())}
    assert line["gpu"] == "not available"
    assert line["value"] > 0
    for row in line["detail"].values():
        assert "error" not in row and row["snr_db"] >= bench.SNR_GATE_DB


def test_power_limit_without_nvidia_smi(monkeypatch):
    import subprocess as sp

    from fftlab.plan.hardware import gpu_name_and_power_limit

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(sp, "run", missing)
    assert gpu_name_and_power_limit() == "not available"
