"""Simulator(n_devices=D) against one device on gap and corridor, and
checkpoints restored across device counts.  (Funnel and room-evac are in
test_sharded_sim_b.py, so the two halves run on separate workers.)"""

import numpy as np
import pytest

from pedoni_tpu import Simulator, SimulatorOptions, load_scenario
from pedoni_tpu.checkpoint import restore, save

from sharded_compare import SCENARIOS, assert_same_run, run

_ONE = {}


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("name", ["gap", "corridor"])
def test_sharded_simulator_matches_one_device(name, n_devices):
    if name not in _ONE:
        _ONE[name] = run(name, 1)
    assert_same_run(_ONE[name], run(name, n_devices),
                    f"{name} on {n_devices} devices")


@pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (2, 4), (4, 8), (8, 1)])
def test_checkpoint_restores_across_device_counts(tmp_path, src, dst):
    """A checkpoint written on ``src`` devices continues on ``dst``: the
    same agents at the same places, then the same next steps as the
    writer (within the summation-order tolerance)."""
    scenario = load_scenario(SCENARIOS / "corridor.toml")
    a = Simulator(SimulatorOptions(seed=3, n_devices=src), scenario)
    for _ in range(8):
        a.tick()
    save(a, tmp_path / "ck.npz")
    b = Simulator(SimulatorOptions(seed=0, n_devices=dst), scenario)
    restore(b, tmp_path / "ck.npz")
    assert b.step_count == a.step_count
    assert b.pedestrian_count == a.pedestrian_count > 0

    def agents(sim):
        f = sim.state.agents
        act = np.asarray(f.active)
        s = np.asarray(f.speed)[act]
        o = np.argsort(s, kind="stable")
        return s[o], np.asarray(f.pos)[act][o]

    sa, pa = agents(a)
    sb, pb = agents(b)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(pa, pb)
    for _ in range(4):
        assert a.tick().active_ped_count == b.tick().active_ped_count
    sa, pa = agents(a)
    sb, pb = agents(b)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_allclose(pa, pb, atol=1e-4)
