"""chip_smoke.py at CPU sizes: every phase, the device guard and the
shape of its last line. The real sizes run only on the card."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


cs = _load()


@pytest.mark.parametrize("phase", [p.__name__ for p in cs.ONE_CARD_PHASES])
def test_one_card_phase_passes_at_cpu_size(phase):
    getattr(cs, phase)(cs.SMALL, cs.Report(timed=False))


@pytest.mark.parametrize("phase", [p.__name__ for p in cs.FOUR_CARD_PHASES])
def test_four_card_phase_passes_on_virtual_devices(phase):
    from fftlab.dist.mesh import make_mesh_1d

    mesh = make_mesh_1d("tp", devices=jax.devices()[:4])
    getattr(cs, phase)(cs.SMALL, cs.Report(timed=False), mesh)


def test_phase_sizes_keep_their_names():
    # FULL is what the card runs; SMALL mirrors every field.
    assert cs.FULL.n == 1 << 20 and cs.FULL.batch == 16
    assert cs.FULL.four_step_n == 1 << 28 and cs.FULL.prime == 500009
    assert set(vars(cs.SMALL)) == set(vars(cs.FULL))


def test_failing_check_fails_its_phase():
    import numpy as np

    def phase_bad(s, rep):
        """bad phase"""
        rep.check("mismatch", np.ones(8), np.zeros(8) + 2.0)

    assert cs.run_phases([phase_bad], cs.SMALL, timed=False) == ["phase_bad"]
    with pytest.raises(cs.PhaseFailed):
        cs.Report(timed=False).check("low", np.ones(8) * 1.001,
                                     np.ones(8))


def test_require_gpu_fails_on_cpu():
    with pytest.raises(SystemExit):
        cs.require_gpu()


def test_main_fails_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_shape(count):
    line = json.loads(cs.result_line(jax.devices()[:count]))
    assert line == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind, "count": count}}


def test_script_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository the script must fail and print no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
