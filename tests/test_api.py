"""The PedestrianModel object API (models/mod.rs trait parity) and
checkpoint/diagnostics subsystems."""

import json

import numpy as np
import pytest

from pedoni_tpu import Simulator, SimulatorOptions, loads_scenario
from pedoni_tpu.checkpoint import load_state, restore, save, save_state
from pedoni_tpu.diagnostics import DiagnosticLog, StepRecord
from pedoni_tpu.field import Field
from pedoni_tpu.models.base import Pedestrian, SocialForceModel

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


def test_pedestrian_model_trait():
    scenario = loads_scenario(SCENARIO)
    field = Field.from_scenario(scenario, unit=0.25)
    model = SocialForceModel(SimulatorOptions(), scenario, field,
                             capacity=256, seed=0)
    # The trait ctor spawns nothing (models/mod.rs:13-25); the Simulator
    # pushes once-group agents through spawn_pedestrians (lib.rs:37-52).
    assert model.get_pedestrian_count() == 0
    model.spawn_pedestrians(field, [
        Pedestrian(pos=(2.0, 2.0 + i), destination=1) for i in range(10)
    ])
    assert model.get_pedestrian_count() == 10
    model.spawn_pedestrians(field, [Pedestrian(pos=(8.0, 8.0), destination=1)])
    # New agent visible after the next state update.
    model.update_states(scenario, field)
    assert model.get_pedestrian_count() == 11
    peds = model.list_pedestrians()
    assert len(peds) == 11
    xs = [p.pos[0] for p in peds]
    assert all(0 <= x <= 16 for x in xs)
    for _ in range(30):
        model.update_states(scenario, field)
    # Everyone marches right; eventually some despawn.
    assert model.get_pedestrian_count() <= 11


def test_checkpoint_roundtrip(tmp_path):
    sim = Simulator(SimulatorOptions(seed=4), loads_scenario(SCENARIO))
    for _ in range(10):
        sim.tick()
    p = tmp_path / "ck.npz"
    save(sim, p)

    # A fresh simulator restored from the checkpoint continues identically.
    sim2 = Simulator(SimulatorOptions(seed=999), loads_scenario(SCENARIO))
    restore(sim2, p)
    assert sim2.step_count == sim.step_count
    r1 = [sim.tick().active_ped_count for _ in range(5)]
    r2 = [sim2.tick().active_ped_count for _ in range(5)]
    assert r1 == r2
    p1, _ = sim.list_pedestrians()
    p2, _ = sim2.list_pedestrians()
    np.testing.assert_allclose(
        p1[np.lexsort(p1.T)], p2[np.lexsort(p2.T)], atol=1e-6
    )


def test_checkpoint_state_functions(tmp_path):
    sim = Simulator(SimulatorOptions(seed=1), loads_scenario(SCENARIO))
    sim.tick()
    p = tmp_path / "s.npz"
    save_state(sim.state, p, step_count=1)
    state, n = load_state(p)
    assert n == 1
    np.testing.assert_array_equal(
        np.asarray(state.agents.active), np.asarray(sim.state.agents.active)
    )


def test_diagnostic_log_schema(tmp_path):
    # The exported JSON must match the reference schema exactly
    # (diagnostic.rs:6-50) so downstream tooling carries over.
    log = DiagnosticLog(model="sfm/gpux1", scenario="x.toml")
    log.time_calc_field = 0.5
    log.push(StepRecord(active_ped_count=3, time_spawn=0.0,
                        time_calc_state=0.01))
    log.push(StepRecord(active_ped_count=4, time_spawn=0.0,
                        time_calc_state=0.02, time_calc_state_kernel=0.005))
    out = tmp_path / "log.json"
    log.write(out)
    d = json.loads(out.read_text())
    assert set(d.keys()) == {
        "model", "scenario", "total_steps", "preprocess_metrics", "step_metrics"
    }
    assert d["total_steps"] == 2
    assert d["preprocess_metrics"] == {"time_calc_field": 0.5}
    sm = d["step_metrics"]
    assert sm["active_ped_count"] == [3, 4]
    assert sm["time_calc_state_kernel"] == [None, 0.005]


def test_cli_headless(tmp_path):
    from pedoni_tpu.cli import build_parser, run_headless

    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    args = build_parser().parse_args(
        [str(scen), "-H", "--max-steps", "20", "-s", "0",
         "--log-dir", str(tmp_path / "logs"), "--capacity", "256"]
    )
    out = run_headless(args)
    d = json.loads(out.read_text())
    # --max-steps N runs exactly N ticks (the reference's loop break).
    assert d["total_steps"] == 20
    assert len(d["step_metrics"]["active_ped_count"]) == 20


def test_cli_resume(tmp_path):
    from pedoni_tpu.cli import build_parser, run_headless

    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    ckdir = tmp_path / "cks"
    args = build_parser().parse_args(
        [str(scen), "-H", "--max-steps", "10", "-s", "0",
         "--log-dir", str(tmp_path / "logs"), "--capacity", "256",
         "--checkpoint-every", "5", "--checkpoint-dir", str(ckdir)]
    )
    run_headless(args)
    cks = sorted(ckdir.glob("*.npz"))
    assert len(cks) >= 2
    args2 = build_parser().parse_args(
        [str(scen), "-H", "--max-steps", "5", "-s", "0",
         "--log-dir", str(tmp_path / "logs2"), "--capacity", "256",
         "--resume", str(cks[-1])]
    )
    out = run_headless(args2)
    assert out.exists()


def test_renderer_terminal_and_frame(tmp_path, capsys):
    from pedoni_tpu.renderer import TerminalRenderer, save_frame

    scenario = loads_scenario(SCENARIO)
    r = TerminalRenderer(scenario, width=40)
    pos = np.array([[4.0, 8.0], [12.0, 8.0]])
    dest = np.array([0, 1])
    r.draw(pos, dest, step=1)
    outp = capsys.readouterr().out
    assert "step" in outp

    png = tmp_path / "f.png"
    save_frame(scenario, pos, dest, str(png))
    assert png.stat().st_size > 1000
