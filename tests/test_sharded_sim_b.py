"""Simulator(n_devices=D) against one device on funnel and room-evac
(gap and corridor are in test_sharded_sim_a.py)."""

import pytest

from sharded_compare import assert_same_run, run

_ONE = {}


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("name", ["funnel", "room-evac"])
def test_sharded_simulator_matches_one_device(name, n_devices):
    if name not in _ONE:
        _ONE[name] = run(name, 1)
    assert_same_run(_ONE[name], run(name, n_devices),
                    f"{name} on {n_devices} devices")
