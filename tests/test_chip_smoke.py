"""chip_smoke.py's contract and phase functions, at tiny sizes on the CPU.

The script itself runs on a GPU; here its device refusal, its last line
and each phase's checks run on the 8 virtual CPU devices."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_refuses_the_cpu():
    """No GPU: non-zero exit and no result line on stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr


def test_require_gpus_raises_on_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.require_gpus(1)


@pytest.mark.parametrize("count", [1, 4])
def test_result_line(count):
    line = chip_smoke.result_line(jax.devices()[:count])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": count}}
    assert "\n" not in line


def test_phase_scenario_evacuates_gap():
    assert chip_smoke.phase_scenario(backend="cpu") <= 300


def test_phase_oracle_small_crop():
    assert chip_smoke.phase_oracle(n_agents=100, n_steps=10) <= chip_smoke.ORACLE_TOL


def test_phase_headline_and_cpu_compare():
    chip_smoke._import_repo()
    sim = chip_smoke.phase_headline("test", n_agents=2000, warmup=2,
                                    windows=2, window=2)
    assert chip_smoke.phase_cpu(sim) <= chip_smoke.CROSS_TOL


@pytest.mark.parametrize("n_devices", [2, 4])
def test_phase_sharded_small(n_devices):
    # 1200 agents per device keep the halo ghosts below the default
    # package capacity, as 1M per device does on the cards
    worst = chip_smoke.phase_sharded(n_devices, agents_per_device=1200,
                                     warmup=2, windows=2, window=2)
    assert worst <= chip_smoke.CROSS_TOL


def test_tag_diff_detects_different_agents():
    import numpy as np

    pos = np.zeros((3, 2), np.float32)
    act = np.array([True, True, False])
    a = (pos, act, np.array([1.0, 2.0, 3.0], np.float32))
    b = (pos, act, np.array([1.0, 3.0, 2.0], np.float32))
    with pytest.raises(chip_smoke.SmokeError, match="different agents"):
        chip_smoke._tag_diff(a, b)
