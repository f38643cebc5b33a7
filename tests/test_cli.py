"""The CLI's device flag (-b auto|cpu|gpu, args.rs:20-21) and --devices."""

import json

import pytest

from pedoni_tpu.cli import build_parser, main

SCENARIO = """
[field]
size = [16, 16]
[[waypoints]]
line = [[2, 2], [2, 14]]
[[waypoints]]
line = [[14, 2], [14, 14]]
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "once", count = 10 }
"""


def _run(tmp_path, *flags):
    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    logs = tmp_path / "logs"
    assert main([str(scen), "-H", "--max-steps", "5", "-s", "0",
                 "--log-dir", str(logs), *flags]) == 0
    (out,) = logs.glob("*_log.json")
    return json.loads(out.read_text())


def test_gpu_flag_without_gpu_fails(tmp_path):
    with pytest.raises(SystemExit, match="no gpu device"):
        _run(tmp_path, "-b", "gpu")


def test_cpu_flag_runs(tmp_path):
    d = _run(tmp_path, "-b", "cpu")
    assert d["total_steps"] == 5
    assert d["model"] == "sfm/cpux1"


def test_devices_flag_runs_on_the_cpu_mesh(tmp_path):
    d = _run(tmp_path, "--devices", "2")
    assert d["total_steps"] == 5
    assert d["model"] == "sfm/cpux2"
    assert d["step_metrics"]["active_ped_count"][-1] == 10


@pytest.mark.parametrize("backend", ["cuda", "grid", "pallas", "xla"])
def test_removed_backend_choices_are_rejected(backend, capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["-b", backend])
    assert "invalid choice" in capsys.readouterr().err
