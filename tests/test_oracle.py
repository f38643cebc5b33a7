"""Differential trajectories: independent f64 oracle vs the real step.

tests/oracle_sfm.py is a per-agent scalar transliteration of the
reference physics that shares NO code with pedoni_tpu's vectorized
implementations.  Running the same initial state through the oracle and
through the step for dozens of steps catches any misreading of the
reference (sign conventions, the half-cell sampling offset, FOV
inequality direction) that step-vs-step equivalence tests cannot see.

Spawning is disabled (the oracle cannot reproduce jax.random streams);
agents carry unique speeds so trajectories can be matched across the
step's cell-sorted slot order.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models.sfm import (
    AgentState,
    SimState,
    StepConfig,
    device_inputs,
    make_step,
)
from pedoni_tpu.scenario import loads_scenario

from oracle_sfm import max_tagged_error, oracle_run, oracle_step

SCENARIO = """
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
"""

N = 100
N_STEPS = 50
CAP = 128
UNIT = 1.4  # the reference's neighbor cell


@pytest.fixture(scope="module")
def setup():
    sc = loads_scenario(SCENARIO)
    field = Field.from_scenario(sc, unit=0.25)
    maps = FieldMaps.from_field(field)
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=10)
    rng = np.random.default_rng(42)
    pos = rng.uniform(1.0, np.array(sc.size) - 1.0, (CAP, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (CAP, 2)).astype(np.float32)
    # unique speeds double as agent IDs across slot reordering
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    dest = rng.integers(0, 2, CAP).astype(np.int32)
    active = np.arange(CAP) < N
    return sc, field, maps, cfg, pos, vel, speed, dest, active


def _oracle_traj(sc, field, pos, vel, speed, dest, active, unit=UNIT,
                 n_steps=N_STEPS, **modes):
    return oracle_run(field, pos, vel, speed, dest, active, sc.size, unit,
                      n_steps, **modes)


def _seg_obstacles(sc):
    """(x0, y0, x1, y1, width) tuples for oracle_step's segment mode."""
    return [(o.line[0][0], o.line[0][1], o.line[1][0], o.line[1][1], o.width)
            for o in sc.obstacles]


def _run_xla(cfg, maps, pos, vel, speed, dest, active, n_steps=N_STEPS):
    agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                        active=jnp.asarray(active))
    st = SimState(agents=agents, key=jax.random.PRNGKey(0), step=jnp.int32(0))
    dfield, obstacles = device_inputs(cfg, maps)
    step = jax.jit(make_step(cfg, maps))
    for _ in range(n_steps):
        st, _ = step(st, dfield.rows, obstacles)
    return st.agents


def _compare(speed, o_pos, o_act, b_pos, b_act, b_speed, what):
    """Match step agents to oracle agents by their unique speed tag."""
    worst = max_tagged_error(speed, o_pos, o_act, b_pos, b_act, b_speed)
    # f32 step vs f64 oracle: per-step rounding ~1e-6 amplified over
    # 50 interacting steps; 5e-3 m catches any semantic error (a sign or
    # offset bug displaces by whole cells) while allowing float drift.
    assert worst < 5e-3, f"{what}: max position divergence {worst:.2e}"


def test_xla_backend_matches_oracle(setup):
    sc, field, maps, cfg, pos, vel, speed, dest, active = setup
    o_pos, o_act = _oracle_traj(sc, field, pos, vel, speed, dest, active)

    agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                        active=jnp.asarray(active))
    st = SimState(agents=agents, key=jax.random.PRNGKey(0), step=jnp.int32(0))
    dfield, obstacles = device_inputs(cfg, maps)
    step = jax.jit(make_step(cfg, maps))
    for _ in range(N_STEPS):
        st, _ = step(st, dfield.rows, obstacles)
    a = st.agents
    _compare(speed, o_pos, o_act, np.asarray(a.pos), np.asarray(a.active),
             np.asarray(a.speed), "xla")


def test_xla_all_pairs_matches_oracle(setup):
    """The all-pairs debug branch (sfm.rs:158-184) vs the oracle's
    all-pairs branch — same cutoff, no neighbor structure on either
    side."""
    sc, field, maps, _cfg, pos, vel, speed, dest, active = setup
    o_pos, o_act = _oracle_traj(sc, field, pos, vel, speed, dest, active,
                                use_neighbor_grid=False)
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=10, use_neighbor_grid=False)
    a = _run_xla(cfg, maps, pos, vel, speed, dest, active)
    _compare(speed, o_pos, o_act, np.asarray(a.pos), np.asarray(a.active),
             np.asarray(a.speed), "xla all-pairs")


def test_xla_segment_obstacles_match_oracle(setup):
    """The per-segment obstacle branch (sfm.rs:194-237) vs the oracle's
    independent transliteration of the 4-edge rectangle geometry."""
    sc, field, maps, _cfg, pos, vel, speed, dest, active = setup
    o_pos, o_act = _oracle_traj(sc, field, pos, vel, speed, dest, active,
                                obstacles=_seg_obstacles(sc))
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=10, use_distance_map=False)
    a = _run_xla(cfg, maps, pos, vel, speed, dest, active)
    _compare(speed, o_pos, o_act, np.asarray(a.pos), np.asarray(a.active),
             np.asarray(a.speed), "xla segments")


# Crowd shapes against the oracle, each under both obstacle modes: the
# pair pass's cell layout sees a uniform crowd, W=4 band exits (per-agent
# destination maps), a sparse crowd in the first 1/8 of the rows (mostly
# empty cells), and a jam whose fullest cell sits just under K.

_BANDS4 = """
[field]
size = [18, 12]
[[waypoints]]
line = [[1, 1], [1, 3.5]]
[[waypoints]]
line = [[1, 3.5], [1, 6]]
[[waypoints]]
line = [[1, 6], [1, 8.5]]
[[waypoints]]
line = [[1, 8.5], [1, 11]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
"""


def _crowd(shape, sc, rng):
    """Initial (pos, vel, dest) of CAP slots for one crowd shape."""
    w, h = sc.size
    if shape == "sparse":
        lo, hi = np.array([1.0, 0.5]), np.array([w - 1.0, h / 8])
    elif shape == "jam":
        lo, hi = np.array([3.0, 6.0]), np.array([8.0, 11.0])
    else:
        lo, hi = np.array([1.0, 1.0]), np.array([w - 1.0, h - 1.0])
    pos = rng.uniform(lo, hi, (CAP, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (CAP, 2)).astype(np.float32)
    if shape == "bands4":
        dest = np.clip(((pos[:, 1] - 1.0) // 2.5).astype(np.int32), 0, 3)
    elif shape == "open":
        dest = rng.integers(0, 2, CAP).astype(np.int32)
    else:
        dest = np.zeros(CAP, np.int32)
    return pos, vel, dest


@pytest.mark.parametrize("obstacle_mode", ["distance_map", "segments"])
@pytest.mark.parametrize("shape", ["open", "bands4", "sparse", "jam"])
def test_crowd_shapes_match_oracle(shape, obstacle_mode):
    sc = loads_scenario(_BANDS4 if shape == "bands4" else SCENARIO)
    field = Field.from_scenario(sc, unit=0.25)
    maps = FieldMaps.from_field(field)
    pos, vel, dest = _crowd(shape, sc, np.random.default_rng(7))
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    active = np.arange(CAP) < N
    cell = (np.floor(pos[active] / UNIT).astype(np.int64)
            @ np.array([1, 1 << 20]))
    k = int(np.bincount(np.unique(cell, return_inverse=True)[1]).max())
    # the jam starts one agent under K; the others keep the default room
    table = k + 1 if shape == "jam" else k + 6
    segments = obstacle_mode == "segments"
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=table,
                           use_distance_map=not segments)
    n_steps = 20
    o_pos, o_act = _oracle_traj(
        sc, field, pos, vel, speed, dest, active, n_steps=n_steps,
        **({"obstacles": _seg_obstacles(sc)} if segments else {}))

    agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                        active=jnp.asarray(active))
    st = SimState(agents=agents, key=jax.random.PRNGKey(0), step=jnp.int32(0))
    dfield, obstacles = device_inputs(cfg, maps)
    step = jax.jit(make_step(cfg, maps))
    for _ in range(n_steps):
        st, m = step(st, dfield.rows, obstacles)
        # the oracle's cells are unbounded: a full cell would be a
        # different interaction set, not a float error
        assert int(m.n_overflow) == 0
    a = st.agents
    _compare(speed, o_pos, o_act, np.asarray(a.pos), np.asarray(a.active),
             np.asarray(a.speed), f"{shape}/{obstacle_mode}")


# ---------------------------------------------------------------------------
# Evacuation step-count parity — the reference author's OWN fidelity metric
# (steps until 0 active agents over repeated runs, the commented-out harness
# at /root/reference/pedoni/src/main.rs:58-77), judged here by the
# independent f64 oracle instead of a frozen self-measured band
# (test_regression_bands.py freezes the repo's own round-1 numbers; this
# test de-correlates the referee).  64 agents evacuate scenarios/gap.toml
# through the wall gap from identical initial states; measured
# 2026-08-19 at the 1.5 m cell: oracle 252/262/259 steps (seeds 1/2/3),
# step 251/264/262 — max |step - oracle| = 3 steps (1.2%) over a
# ~260-step chaotic queue drain.  Band 5% catches semantic drift
# (a physics misreading shifts the drain by tens of steps) while allowing
# f32-vs-f64 trajectory divergence.
# ---------------------------------------------------------------------------

_GAP = pathlib.Path(__file__).parents[1] / "scenarios" / "gap.toml"
_NARROW_GAP = pathlib.Path("/root/reference/scenarios/narrow-gap.toml")
_EVAC_MAX = 600

# A trimmed multi-waypoint once-scenario (evacuation.toml's class: several
# band exits, nearest-exit assignment) small enough for the f64 oracle to
# chew: 3 exit bands on the left edge, a central wall with passages above
# and below, 48 agents starting on the right.
_MULTIWP = """
[field]
size = [30, 21]
[[waypoints]]
line = [[2, 1], [2, 7]]
[[waypoints]]
line = [[2, 7], [2, 14]]
[[waypoints]]
line = [[2, 14], [2, 20]]
[[obstacles]]
line = [[15, 4], [15, 17]]
width = 2
"""


def _init_gap(seed):
    """64 agents in the left chamber of gap.toml, heading to waypoint 1
    on the far side of the wall (same stream as the measured prototype)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(2.0, 10.0, CAP)
    pos[:, 1] = rng.uniform(2.0, 22.0, CAP)
    dest = np.ones(CAP, np.int32)
    return pos, dest, 64


def _init_narrow_gap(seed):
    """The reference's narrow-gap.toml (once, count 50): 50 agents left
    of the 2 m wall whose only opening is the 3-cell gap at y 10..13,
    bound for waypoint 1 at x = 12."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(1.5, 8.0, CAP)
    pos[:, 1] = rng.uniform(2.0, 18.0, CAP)
    dest = np.ones(CAP, np.int32)
    return pos, dest, 50


# A trimmed bottleneck-class funnel (the reference's stress family:
# bottleneck.toml's two angled walls converging to a central pinch —
# /root/reference/pedoni/src/main.rs:58-77 ran its harness on exactly
# this scenario class) at oracle-chewable scale: two diagonal walls
# funnel 96 once-spawned agents through a ~3 m opening at x = 16, then
# on to the exit line at x = 28.  Funnel congestion differs from gap's
# flat-wall queue: agents slide ALONG the diagonals into the pinch, so
# the obstacle-force tangent behavior shapes the drain rate.
_FUNNEL = """
[field]
size = [30, 20]
[[waypoints]]
line = [[2, 2], [2, 18]]
[[waypoints]]
line = [[28, 2], [28, 18]]
[[obstacles]]
line = [[8, 0], [16, 8]]
width = 1
[[obstacles]]
line = [[8, 20], [16, 12]]
width = 1
"""


def _init_funnel(seed):
    """96 agents filling the funnel mouth, bound for the far-side exit
    through the pinch (bottleneck.toml queue at oracle scale)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(2.0, 7.5, CAP)
    pos[:, 1] = rng.uniform(2.0, 18.0, CAP)
    dest = np.ones(CAP, np.int32)
    return pos, dest, 96


def _init_multiwp(seed):
    """48 agents on the right half, each bound for its own y-band exit
    (nearest-exit assignment, evacuation.toml semantics)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(20.0, 28.0, CAP)
    pos[:, 1] = rng.uniform(2.0, 19.0, CAP)
    dest = np.minimum(pos[:, 1] // 7.0, 2).astype(np.int32)
    return pos, dest, 48


# geometry -> (scenario source, init fn, seeds, table_capacity).
# gap keeps the 3 seeds measured 2026-08-19 (doc above); the other
# geometries run 5 seeds each (the reference's own harness ran 20
# repeats, main.rs:58-77).
_EVAC_GEOMS = {
    "gap": (("file", _GAP), _init_gap, (1, 2, 3), 12),
    "narrow_gap": (("file", _NARROW_GAP), _init_narrow_gap,
                   (1, 2, 3, 4, 5), 12),
    "multiwp": (("inline", _MULTIWP), _init_multiwp, (1, 2, 3, 4, 5), 12),
    "funnel": (("inline", _FUNNEL), _init_funnel, (1, 2, 3, 4, 5), 14),
}


@pytest.fixture(scope="module", params=sorted(_EVAC_GEOMS))
def evac_setup(request):
    from pedoni_tpu.scenario import load_scenario

    geom = request.param
    (kind, src), init, seeds, table = _EVAC_GEOMS[geom]
    sc = load_scenario(src) if kind == "file" else loads_scenario(src)
    field = Field.from_scenario(sc, unit=0.25)
    maps = FieldMaps.from_field(field)
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=table)
    return geom, sc, field, maps, cfg, init, seeds


def _evac_initial(init, seed):
    pos, dest, n = init(seed)
    vel = np.zeros((CAP, 2), np.float32)
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    active = np.arange(CAP) < n
    return pos, vel, speed, dest, active


def _oracle_evac_steps(geom, sc, field, init, seed):
    pos, vel, speed, dest, active = _evac_initial(init, seed)
    p, v, a = pos, vel, active.copy()
    steps = _EVAC_MAX + 1
    for i in range(1, _EVAC_MAX + 1):
        p, v, a = oracle_step(field, p, v, speed.astype(np.float64),
                              dest, a, sc.size, UNIT)
        if not a.any():
            steps = i
            break
    return steps


@pytest.mark.slow
def test_evacuation_step_count_matches_oracle(evac_setup):
    geom, sc, field, maps, cfg, init, seeds = evac_setup
    for seed in seeds:
        o_steps = _oracle_evac_steps(geom, sc, field, init, seed)
        pos, vel, speed, dest, active = _evac_initial(init, seed)
        agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                            active=jnp.asarray(active))
        st = SimState(agents=agents, key=jax.random.PRNGKey(0),
                      step=jnp.int32(0))
        dfield, obstacles = device_inputs(cfg, maps)
        step = jax.jit(make_step(cfg, maps))
        b_steps = _EVAC_MAX + 1
        lost = 0
        for i in range(1, _EVAC_MAX + 1):
            st, m = step(st, dfield.rows, obstacles)
            lost += int(m.n_dropped) + int(m.n_overflow)
            if int(m.n_active) == 0:
                b_steps = i
                break
        # A cell-table overflow near the gap queue would change the
        # interaction set while masking a capacity bug.
        assert lost == 0, f"{geom} seed {seed}: {lost} agents lost"
        assert o_steps <= _EVAC_MAX and b_steps <= _EVAC_MAX, (
            f"{geom} evacuation did not complete: oracle {o_steps}, "
            f"step {b_steps}")
        assert abs(b_steps - o_steps) <= max(3, round(0.05 * o_steps)), (
            f"{geom} seed {seed}: evacuated in {b_steps} steps, "
            f"oracle {o_steps} — outside the 5% parity band (gap.toml "
            f"measured max deviation 3 steps)")
