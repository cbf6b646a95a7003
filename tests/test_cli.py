"""Smoke tests for every CLI demo main() (the reference runs each demo
binary in test_build.sh; here each module main runs in-process)."""

import sys

import pytest


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    """The mains turn on the persistent compile cache; keep the test
    process's compilations out of the checkout."""
    import fftlab.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: str(cc.DEFAULT_DIR))


def _run(module: str, argv: list[str]):
    import importlib

    old = sys.argv
    sys.argv = ["prog"] + argv
    try:
        mod = importlib.import_module(f"fftlab.cli.{module}")
        mod.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("module,argv", [
    ("features", []),
    ("benchmark", ["--sizes", "64,256", "--algos", "radix2_dit,stockham_mxu"]),
    ("pitch", ["--freqs", "220,440"]),
    ("filter", ["--n", "1024"]),
    ("image", ["--size", "32"]),
    ("spectrum", ["--n", "4096"]),
    ("convolution", ["--nx", "1024", "--nh", "33"]),
    ("analyzer", ["--frames", "1", "--fft-size", "512", "--hop", "128"]),
    ("dist_demo", []),
    ("serve", ["--taps", "65", "--chunk", "16384"]),
    ("bigfft", []),
])
def test_cli_demo_runs(capsys, module, argv):
    _run(module, argv)
    out = capsys.readouterr().out
    assert len(out) > 50, f"{module} produced no meaningful output"


def test_quickstart_menu_lists(capsys):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "quickstart",
        os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "quickstart.py"),
    )
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    qs.show_menu()
    out = capsys.readouterr().out
    assert "fftlab quickstart" in out and "benchmark" in out.lower()
