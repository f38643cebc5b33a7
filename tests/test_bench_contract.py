"""The bench contract: bench.py prints exactly one JSON line with the
agreed keys and the device it ran on, and refuses to measure anything but
a GPU unless the CPU is asked for."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(*flags):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # one CPU device, not the tests' eight
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--agents", "2000",
         "--steps", "4", "--windows", "2", "--warmup", "1", *flags],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_bench_json_contract():
    proc = _bench("--allow-cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, proc.stdout
    d = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(d.keys())
    assert d["metric"] == "agent_steps_per_sec"
    assert d["value"] > 0
    assert d["vs_baseline"] == d["value"] / 1e9
    assert d["ms_per_step"] > 0
    assert d["ms_per_step_min"] <= d["ms_per_step"] <= d["ms_per_step_max"]
    assert d["method"].startswith("median of 2 windows x 2 steps")
    assert d["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "card": "none"}


def test_bench_refuses_the_cpu():
    proc = _bench()
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "--allow-cpu" in proc.stderr


def test_card_info_without_nvidia_smi(monkeypatch):
    sys.path.insert(0, ROOT)
    import bench

    monkeypatch.setenv("PATH", "")
    assert bench.card_info() == "not available"
