# fftlab build/test/bench entry points (reference Makefile analog:
# all/test/benchmark/lint targets, platform-agnostic).

PY ?= python

.PHONY: all native install test test-fast bench smoke bench-table demos \
        lint release clean

all: native

# `make install` analog (reference Makefile:216-233): editable install
# + console scripts (fftlab-*). --no-build-isolation/--no-deps keep it
# fully offline (this image has no package index).
install:
	$(PY) -m pip install --no-build-isolation --no-deps -e .

# C++ host runtime (WAV IO, ring buffer, Q15 FFT) -> libfftlab_native.so
native:
	$(MAKE) -C native

# Full suite on 8 virtual CPU devices (conftest forces the platform).
test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -k "not properties"

# Headline JSON benchmark (runs on the default JAX device).
bench:
	$(PY) bench.py

# The main path on one NVIDIA GPU, checked against float64.
smoke:
	$(PY) chip_smoke.py

# Cross-algorithm table.
bench-table:
	$(PY) -m fftlab.cli.benchmark

demos:
	$(PY) -m fftlab.cli.features
	$(PY) -m fftlab.cli.pitch
	$(PY) -m fftlab.cli.filter
	$(PY) examples/minimal.py

# Real lint (reference Makefile:237-243 cppcheck/clang-format analog;
# this image ships no pyflakes/cppcheck, so the Python leg is the AST
# linter in scripts/lint.py and the C++ leg is g++'s analyzer pass).
lint:
	$(PY) -m compileall -q fftlab tests scripts bench.py chip_smoke.py __graft_entry__.py
	$(PY) scripts/lint.py fftlab tests scripts bench.py chip_smoke.py __graft_entry__.py quickstart.py
	g++ -std=c++17 -fsyntax-only -Wall -Wextra -Wpedantic native/*.cpp

# Release packaging (reference Makefile:246-252 analog): sdist + wheel
# via the offline-safe build backend.
release: lint test
	$(PY) -m pip wheel --no-build-isolation --no-deps -w dist .
	@ls -l dist/

clean:
	rm -rf dist build *.egg-info
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
