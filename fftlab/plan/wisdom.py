"""Wisdom: persisted planner knowledge (measured plan timings).

The reference declares FFTW-style wisdom import/export but stubs it
(fft_auto.h:124-137, fft_auto.c:418-426) and leaves FFT_MEASURE a TODO
(fft_auto.c:233-235). Implemented for real here: a process-global table
keyed by (n, precision, kind) holding the measured-best algorithm and its
timing, JSON-(de)serializable (SURVEY.md §5 checkpoint/resume analog).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

_LOCK = threading.Lock()
_WISDOM: dict[str, dict[str, Any]] = {}

def _default_path() -> str:
    """Wisdom file location, resolved at CALL time so
    FFTLAB_WISDOM_PATH can redirect it (tests point it at a tmp file;
    deployments can share a warmed file)."""
    return os.environ.get(
        "FFTLAB_WISDOM_PATH",
        os.path.expanduser("~/.cache/fftlab/wisdom.json"),
    )


DEFAULT_PATH = _default_path()  # informational; functions resolve live


def _key(n: int, precision: str, kind: str = "c2c") -> str:
    return f"{kind}:{n}:{precision}"


def record(n: int, precision: str, algorithm: str, time_ms: float, kind: str = "c2c",
           extra: dict | None = None) -> None:
    with _LOCK:
        _WISDOM[_key(n, precision, kind)] = {
            "algorithm": algorithm,
            "time_ms": float(time_ms),
            **(extra or {}),
        }


def lookup(n: int, precision: str, kind: str = "c2c") -> dict[str, Any] | None:
    with _LOCK:
        return _WISDOM.get(_key(n, precision, kind))


def forget() -> None:
    """fft_forget_wisdom analog (fft_auto.h:136)."""
    with _LOCK:
        _WISDOM.clear()


def export_wisdom(path: str | None = None) -> str:
    """fft_export_wisdom analog (fft_auto.h:128) — JSON, returns the path."""
    path = path or _default_path()
    with _LOCK:
        blob = json.dumps(_WISDOM, indent=2, sort_keys=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(blob)
    return path


def import_wisdom(path: str | None = None, overwrite: bool = True) -> int:
    """fft_import_wisdom analog (fft_auto.h:132) — returns #entries loaded.

    `overwrite=False` keeps existing in-memory entries (used by the
    lazy auto-load: a measurement taken THIS process is fresher than
    the file)."""
    path = path or _default_path()
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"malformed wisdom file {path}")
    with _LOCK:
        if overwrite:
            _WISDOM.update(data)
        else:
            for k, v in data.items():
                _WISDOM.setdefault(k, v)
        return len(data)


def snapshot() -> dict[str, dict[str, Any]]:
    with _LOCK:
        return dict(_WISDOM)
