"""Shared check for the sharded-Simulator tests: a bundled scenario run on
D devices against the same scenario on one device."""

import pathlib

import numpy as np

from pedoni_tpu import Simulator, SimulatorOptions, load_scenario

SCENARIOS = pathlib.Path(__file__).resolve().parents[1] / "scenarios"
N_STEPS = 20
# f32 pair sums run in another order on each side; over 20 steps of a
# crowd that is still spreading out that stays far below a millimetre
TOL = 1e-4


def run(name: str, n_devices: int, seed: int = 1):
    """(active count per step, final agents) of ``N_STEPS`` ticks."""
    sim = Simulator(SimulatorOptions(seed=seed, n_devices=n_devices),
                    load_scenario(SCENARIOS / f"{name}.toml"))
    counts = [sim.tick().active_ped_count for _ in range(N_STEPS)]
    a = sim.state.agents
    act = np.asarray(a.active)
    return counts, np.asarray(a.pos)[act], np.asarray(a.speed)[act]


def assert_same_run(one, many, what: str) -> None:
    """Equal counts every step, and the same agents (matched by their
    desired speed, unique per agent) within TOL."""
    (c1, p1, s1), (cd, pd, sd) = one, many
    assert c1 == cd, f"{what}: active counts {cd} != one device {c1}"
    o1, od = np.argsort(s1, kind="stable"), np.argsort(sd, kind="stable")
    np.testing.assert_array_equal(s1[o1], sd[od], err_msg=what)
    np.testing.assert_allclose(pd[od], p1[o1], atol=TOL, err_msg=what)
