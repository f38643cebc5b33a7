"""Spatial sharding tests on the 8-device virtual CPU mesh.

The key invariant (SURVEY.md section 4): a sharded run must equal the
single-device run — owned agents near strip boundaries see the identical
neighbor set via halo ghosts, so results match up to f32 summation order.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models.sfm import StepConfig, device_inputs, make_initial_state, make_step
from pedoni_tpu.parallel.spatial import (
    ShardedConfig,
    dryrun,
    make_sharded_step,
    shard_state,
)
from pedoni_tpu.scenario import loads_scenario

SCENARIO = """
[field]
size = [32, 16]
[[waypoints]]
line = [[2, 2], [2, 14]]
[[waypoints]]
line = [[30, 2], [30, 14]]
[[obstacles]]
line = [[16, 0], [16, 6]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 6.0 }
[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "once", count = 48 }
"""


@pytest.fixture(scope="module")
def setup():
    scenario = loads_scenario(SCENARIO)
    field = Field.from_scenario(scenario, unit=0.25)
    maps = FieldMaps.from_field(field)
    cfg = StepConfig.build(scenario, capacity=1024,
                           table_capacity=12)
    return scenario, field, maps, cfg


def _run_single(cfg, maps, n_steps, seed=0):
    step = jax.jit(make_step(cfg, maps))
    state = make_initial_state(cfg, seed=seed)
    dfield, obstacles = device_inputs(cfg, maps)
    for _ in range(n_steps):
        state, metrics = step(state, dfield.rows, obstacles)
    active = np.asarray(state.agents.active)
    pos = np.asarray(state.agents.pos)[active]
    return pos, int(metrics.n_active)


def _run_sharded(cfg, maps, n_devices, n_steps, seed=0):
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("x",))
    scfg = ShardedConfig.build(cfg, n_devices, package_capacity=128)
    step = jax.jit(make_sharded_step(scfg, maps, mesh))
    state = shard_state(scfg, mesh, make_initial_state(cfg, seed=seed))
    dfield, obstacles = device_inputs(cfg, maps)
    for _ in range(n_steps):
        state, metrics = step(state, dfield.rows, obstacles)
        # Lockstep: on a 1-core host, deep async dispatch queues can starve
        # the 8 virtual devices' collective-permute rendezvous (XLA CPU
        # spin-waits), aborting the process after a 40 s timeout.
        jax.block_until_ready(state)
    active = np.asarray(state.agents.active)
    pos = np.asarray(state.agents.pos)[active]
    return pos, int(metrics.n_active)


def _sorted(pos):
    return pos[np.lexsort((pos[:, 1], pos[:, 0]))]


def test_sharded_matches_single(setup):
    scenario, field, maps, cfg = setup
    n_steps = 15
    pos1, n1 = _run_single(cfg, maps, n_steps)
    for d in (1, 2, 8):
        posd, nd = _run_sharded(cfg, maps, d, n_steps)
        assert nd == n1, f"{d}-device active count {nd} != single {n1}"
        # f32 summation-order drift compounds over the chaotic steps;
        # 15 steps keeps it well under the tolerance.
        np.testing.assert_allclose(
            _sorted(posd), _sorted(pos1), atol=2e-2,
            err_msg=f"{d}-device positions diverged",
        )


def test_sharded_long_run_stable(setup):
    scenario, field, maps, cfg = setup
    pos, n = _run_sharded(cfg, maps, 8, 120)
    assert n > 0
    assert np.isfinite(pos).all()
    # Agents remain within the field.
    assert (pos[:, 0] >= 0).all() and (pos[:, 0] <= 32).all()
    assert (pos[:, 1] >= 0).all() and (pos[:, 1] <= 16).all()


def test_migration_across_strips(setup):
    # After enough steps, agents spawned in the left strip must appear in
    # right-side strips (they walk the whole field) — proving migration.
    scenario, field, maps, cfg = setup
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    scfg = ShardedConfig.build(cfg, 8, package_capacity=128)
    step = jax.jit(make_sharded_step(scfg, maps, mesh))
    state = shard_state(scfg, mesh, make_initial_state(cfg, seed=3))
    dfield, obstacles = device_inputs(cfg, maps)
    for _ in range(150):
        state, _ = step(state, dfield.rows, obstacles)
        jax.block_until_ready(state)
    active = np.asarray(state.agents.active)
    cl = scfg.local_capacity
    # Device shard d owns slots [d*cl, (d+1)*cl); check occupancy spreads.
    shards_with_agents = {
        d for d in range(8) if active[d * cl : (d + 1) * cl].any()
    }
    assert len(shards_with_agents) >= 4, (
        f"agents only in shards {shards_with_agents}; migration broken?"
    )
    # Shard-locality invariant: every active agent's x lies in its strip.
    pos = np.asarray(state.agents.pos)
    for d in range(8):
        sl = slice(d * cl, (d + 1) * cl)
        act = active[sl]
        if act.any():
            xs = pos[sl][act][:, 0]
            # Integration happens after the exchange, so an agent can step
            # up to ~0.3 m out of its strip before being re-homed at the
            # start of the next step.
            slack = 0.5
            lo = d * scfg.strip_width - slack
            hi = (d + 1) * scfg.strip_width + slack if d < 7 else 1e30
            assert (xs >= lo).all() and (xs < hi).all()


def test_package_saturation_defers_not_destroys():
    """More boundary-crossers than package slots: the shortfall is visible
    in n_deferred and NO agent is lost — unsent emigrants stay active
    locally and migrate on later steps (the round-1 silent-destruction
    bug's regression test)."""
    scenario = loads_scenario("""
[field]
size = [32, 16]
[[waypoints]]
line = [[2, 2], [2, 14]]
[[waypoints]]
line = [[30, 2], [30, 14]]
""")
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))
    cfg = StepConfig.build(scenario, capacity=256, table_capacity=12)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    scfg = ShardedConfig.build(cfg, 8, package_capacity=2)
    step = jax.jit(make_sharded_step(scfg, maps, mesh))

    # 8 agents in strip 0 right at the x=4 boundary, all walking right.
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax.numpy as jnp

    from pedoni_tpu.models.sfm import AgentState, SimState

    n, cl = 8, scfg.local_capacity
    pos = np.zeros((256, 2), np.float32)
    vel = np.zeros((256, 2), np.float32)
    for i in range(n):
        pos[i] = (3.9, 2.0 + 1.5 * i)
        vel[i] = (1.0, 0.0)
    agents = AgentState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        speed=jnp.full((256,), 1.34, jnp.float32),
        dest=jnp.ones((256,), jnp.int32),
        active=jnp.asarray(np.arange(256) < n),
    )
    sh = NamedSharding(mesh, P("x"))
    rep = NamedSharding(mesh, P())
    state = SimState(
        agents=AgentState(*(jax.device_put(a, sh) for a in agents)),
        key=jax.device_put(jax.random.PRNGKey(0), rep),
        step=jax.device_put(jnp.int32(0), rep),
    )
    dfield, obstacles = device_inputs(cfg, maps)

    saw_saturation = False
    for _ in range(10):
        state, metrics = step(state, dfield.rows, obstacles)
        jax.block_until_ready(state)
        assert int(metrics.n_active) == n  # nobody destroyed, ever
        assert int(metrics.n_overflow) == 0  # no cell filled up
        if int(metrics.n_deferred) > 0:
            saw_saturation = True
    assert saw_saturation, "expected the 2-slot package to saturate"
    # All 8 eventually migrated into strip 1+ despite the tiny package.
    active = np.asarray(state.agents.active)
    xs = np.asarray(state.agents.pos)[active][:, 0]
    assert active.sum() == n
    assert (xs >= 4.0).all()
    assert not active[:cl].any(), "agents should have left shard 0"


def test_dryrun_entrypoint():
    dryrun(4)
