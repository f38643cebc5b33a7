"""The social-force model as a single jitted device step.

This is the device-resident re-design of the reference's per-tick pipeline
(lib.rs:64-100 + sfm.rs): where the reference mutates growable host vectors,
we keep fixed-capacity SoA arrays resident on device and express
spawn/despawn as mask flips plus a per-step cell sort (the reference already
re-sorts every step, sfm.rs:58-77, so the layout is faithful).

Step phases (one ``jit``-compiled function, no host round-trips):

1. spawn    — Poisson arrivals per periodic group (lib.rs:70-84), lerped
              along the origin waypoint line, desired speed ~ N(1.34, 0.26)
              (sfm.rs:54).  Fixed per-group candidate caps keep shapes
              static; the seeded ``jax.random`` PRNG improves on the
              reference's unseeded global RNG.
2. despawn  — deactivate agents whose destination potential <= 0.25
              (sfm.rs:69) or that left the neighbor grid
              (neighbor_grid.rs:29).
3. sort     — stable argsort by cell id: the counting-sort analog
              (sfm.rs:61-77).  Active agents compact to the front; candidate
              slots merge in the same sort.
4. forces   — goal + pairwise + obstacle forces over the dense 3x3-cell
              candidate table (sfm.rs:93-241).
5. integrate— trapezoidal with speed clamp (sfm.rs:245-254).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..field import FieldMaps
from ..ops import forcepass, forces as F
from ..ops.neighbor import CellGrid, compute_cell_ids
from ..ops.sampling import DeviceField, sample_field
from ..physics import Physics
from ..scenario import Scenario


class AgentState(NamedTuple):
    """SoA agent arrays, fixed capacity (sfm.rs:26-33 analog)."""

    pos: jnp.ndarray  # [C, 2] f32
    vel: jnp.ndarray  # [C, 2] f32
    speed: jnp.ndarray  # [C] f32 desired speed
    dest: jnp.ndarray  # [C] i32 destination waypoint id
    active: jnp.ndarray  # [C] bool


class SimState(NamedTuple):
    agents: AgentState
    key: jnp.ndarray  # PRNG key
    step: jnp.ndarray  # i32 step counter


class StepMetrics(NamedTuple):
    """Device-side per-step metrics (diagnostic.rs:45-50 analog plus
    capacity health counters the reference lacks)."""

    n_active: jnp.ndarray  # i32
    n_spawned: jnp.ndarray  # i32
    # ACTIONABLE losses only: agents lost to capacity saturation.
    # Expected departures are n_exited.
    n_dropped: jnp.ndarray  # i32
    # agents that found their cell full (no pair forces this step)
    n_overflow: jnp.ndarray  # i32
    # agents in the fullest neighbor cell this step (0 in all-pairs mode)
    # — the Simulator grows table_capacity BEFORE demand reaches K, so
    # cell overflow never drops pair forces under gradual densification
    max_demand: jnp.ndarray = np.int32(0)
    # agents that walked off the field this step (the reference's silent
    # out-of-grid drop, neighbor_grid.rs:29) — EXPECTED on open
    # scenarios, never warned about
    n_exited: jnp.ndarray = np.int32(0)
    # sharded step only: emigrants deferred and halo ghosts truncated by a
    # full exchange package (agents stay alive and retry next step)
    n_deferred: jnp.ndarray = np.int32(0)


def _spawn_cap(lam: float) -> int:
    """Static per-step candidate cap for a Poisson(lam) arrival count.
    P(X > lam + 6 sqrt(lam) + 6) is negligible (< 1e-8 per step)."""
    return int(math.ceil(lam + 6.0 * math.sqrt(max(lam, 0.0)) + 6.0))


@dataclasses.dataclass(frozen=True)
class SpawnPlan:
    """Static spawn tables derived from the scenario's periodic groups."""

    p0: np.ndarray  # [G, 2] origin line start
    p1: np.ndarray  # [G, 2] origin line end
    lam: np.ndarray  # [G] Poisson rate per step (frequency * dt)
    dest: np.ndarray  # [G] destination ids
    caps: tuple[int, ...]  # static per-group candidate caps

    @property
    def total(self) -> int:
        return sum(self.caps)

    @classmethod
    def from_scenario(cls, scenario: Scenario, phys: Physics) -> "SpawnPlan":
        groups = scenario.periodic_groups
        if not groups:
            return cls(
                p0=np.zeros((0, 2), np.float32),
                p1=np.zeros((0, 2), np.float32),
                lam=np.zeros((0,), np.float32),
                dest=np.zeros((0,), np.int32),
                caps=(),
            )
        p0 = np.array([scenario.waypoints[g.origin].line[0] for g in groups], np.float32)
        p1 = np.array([scenario.waypoints[g.origin].line[1] for g in groups], np.float32)
        lam = np.array(
            [g.spawn.frequency * phys.spawn_rate_scale for g in groups], np.float32
        )
        dest = np.array([g.destination for g in groups], np.int32)
        caps = tuple(_spawn_cap(float(l)) for l in lam)
        return cls(p0=p0, p1=p1, lam=lam, dest=dest, caps=caps)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Everything static the step function needs."""

    scenario: Scenario
    physics: Physics
    capacity: int
    grid: CellGrid
    spawn: SpawnPlan
    field_unit: float
    table_capacity: int = 16
    use_neighbor_grid: bool = True
    use_distance_map: bool = True

    @classmethod
    def build(
        cls,
        scenario: Scenario,
        physics: Physics = Physics(),
        capacity: int = 4096,
        neighbor_grid_unit: float = 1.4,
        field_unit: float = 0.25,
        table_capacity: int = 16,
        use_neighbor_grid: bool = True,
        use_distance_map: bool = True,
    ) -> "StepConfig":
        spawn = SpawnPlan.from_scenario(scenario, physics)
        return cls(
            scenario=scenario,
            physics=physics,
            capacity=capacity,
            grid=CellGrid.for_size(scenario.size, neighbor_grid_unit),
            spawn=spawn,
            field_unit=field_unit,
            table_capacity=table_capacity,
            use_neighbor_grid=use_neighbor_grid,
            use_distance_map=use_distance_map,
        )

    def obstacle_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = self.scenario.obstacles
        if not obs:
            return (
                np.zeros((0, 2), np.float32),
                np.zeros((0, 2), np.float32),
                np.zeros((0,), np.float32),
            )
        p0 = np.array([o.line[0] for o in obs], np.float32)
        p1 = np.array([o.line[1] for o in obs], np.float32)
        w = np.array([o.width for o in obs], np.float32)
        return p0, p1, w


def make_initial_state(cfg: StepConfig, seed: int = 0) -> SimState:
    """Initial state: agents from every ``once`` spawn group placed along
    their origin waypoint line (lib.rs:37-52)."""
    key = jax.random.PRNGKey(seed)
    c = cfg.capacity
    pos = np.zeros((c, 2), np.float32)
    vel = np.zeros((c, 2), np.float32)
    speed = np.full((c,), cfg.physics.speed_mean, np.float32)
    dest = np.zeros((c,), np.int32)
    active = np.zeros((c,), bool)

    i = 0
    for g in cfg.scenario.once_groups:
        n = g.spawn.count
        if i + n > c:
            raise ValueError(
                f"capacity {c} too small for {sum(x.spawn.count for x in cfg.scenario.once_groups)} once-spawned agents"
            )
        key, k1, k2 = jax.random.split(key, 3)
        t = np.asarray(jax.random.uniform(k1, (n,)))
        a = np.asarray(cfg.scenario.waypoints[g.origin].line[0], np.float32)
        b = np.asarray(cfg.scenario.waypoints[g.origin].line[1], np.float32)
        pos[i : i + n] = a[None, :] + t[:, None] * (b - a)[None, :]
        sp = cfg.physics.speed_mean + cfg.physics.speed_std * np.asarray(
            jax.random.normal(k2, (n,))
        )
        speed[i : i + n] = np.maximum(sp, 0.1)
        dest[i : i + n] = g.destination
        active[i : i + n] = True
        i += n

    agents = AgentState(
        pos=jnp.asarray(pos),
        vel=jnp.asarray(vel),
        speed=jnp.asarray(speed),
        dest=jnp.asarray(dest),
        active=jnp.asarray(active),
    )
    return SimState(agents=agents, key=key, step=jnp.int32(0))


def _spawn_candidates(cfg: StepConfig, key: jnp.ndarray) -> AgentState:
    """Sample this step's spawn candidates: [S] arrays, S static."""
    plan = cfg.spawn
    s = plan.total
    if s == 0:
        z2 = jnp.zeros((0, 2), jnp.float32)
        z1 = jnp.zeros((0,), jnp.float32)
        return AgentState(z2, z2, z1, jnp.zeros((0,), jnp.int32), jnp.zeros((0,), bool))

    k_count, k_pos, k_speed = jax.random.split(key, 3)
    counts = jax.random.poisson(k_count, jnp.asarray(plan.lam))  # [G]

    # Expand per-group caps into flat candidate slots.
    group_of = np.concatenate(
        [np.full(cap, g, np.int32) for g, cap in enumerate(plan.caps)]
    )
    slot_in_group = np.concatenate(
        [np.arange(cap, dtype=np.int32) for cap in plan.caps]
    )
    group_of_j = jnp.asarray(group_of)
    active = jnp.asarray(slot_in_group) < jnp.take(counts, group_of_j, mode="clip")

    t = jax.random.uniform(k_pos, (s,))
    p0 = jnp.asarray(plan.p0)[group_of]
    p1 = jnp.asarray(plan.p1)[group_of]
    pos = p0 + t[:, None] * (p1 - p0)
    speed = cfg.physics.speed_mean + cfg.physics.speed_std * jax.random.normal(
        k_speed, (s,)
    )
    speed = jnp.maximum(speed, 0.1)
    dest = jnp.asarray(plan.dest)[group_of]
    return AgentState(
        pos=pos,
        vel=jnp.zeros((s, 2), jnp.float32),
        speed=speed,
        dest=dest,
        active=active,
    )


def _all_pairs_acc(cfg: StepConfig, agents: AgentState, e: jnp.ndarray
                   ) -> jnp.ndarray:
    """All-pairs pairwise forces, the --no-neighbor-grid fallback
    (sfm.rs:158-184).  O(C^2); for small scenarios only."""
    c = cfg.capacity
    idx = jnp.arange(c, dtype=jnp.int32)
    cand = jnp.broadcast_to(idx[None, :], (c, c))
    cand_ok = agents.active[None, :] & (cand != idx[:, None])
    return F.pairwise_force(
        agents.pos, agents.vel, e,
        jnp.broadcast_to(agents.pos[None], (c, c, 2)),
        jnp.broadcast_to(agents.vel[None], (c, c, 2)),
        cand_ok, cfg.physics,
    )


def device_inputs(cfg: StepConfig, maps: FieldMaps):
    """Device arrays the step function takes as ARGUMENTS.

    Passing the (large, read-only) field maps as jit arguments instead of
    closure constants keeps them out of the HLO module: baked-in
    multi-MB constants blow the trace/compile time up from seconds to
    minutes and make every scenario its own compile-cache entry.
    """
    field = DeviceField.from_maps(maps)
    obstacles = tuple(map(jnp.asarray, cfg.obstacle_arrays()))
    return field, obstacles


def make_step(cfg: StepConfig, maps: FieldMaps):
    """Build the step function:
    (SimState, DeviceField, obstacles) -> (SimState, StepMetrics).

    ``DeviceField``/``obstacles`` come from :func:`device_inputs` and must be
    passed as arguments on every call (see its docstring for why).
    """
    phys = cfg.physics
    c = cfg.capacity
    grid = cfg.grid
    k = cfg.table_capacity
    # Static padded-map dims (derived from the field geometry so the traced
    # arrays never carry shape information).
    from ..field import PAD

    map_h = int(math.ceil(cfg.scenario.size[1] / cfg.field_unit)) + 2 * PAD
    map_w = int(math.ceil(cfg.scenario.size[0] / cfg.field_unit)) + 2 * PAD

    def step(state: SimState, field_rows: jnp.ndarray, obstacles
             ) -> tuple[SimState, StepMetrics]:
        key, k_spawn = jax.random.split(state.key)
        a = state.agents

        with jax.named_scope("spawn"):
            # 1. spawn candidates, appended past the capacity window.
            cand = _spawn_candidates(cfg, k_spawn)
            n_spawned = jnp.sum(cand.active).astype(jnp.int32)
            ext = AgentState(
                pos=jnp.concatenate([a.pos, cand.pos]),
                vel=jnp.concatenate([a.vel, cand.vel]),
                speed=jnp.concatenate([a.speed, cand.speed]),
                dest=jnp.concatenate([a.dest, cand.dest]),
                active=jnp.concatenate([a.active, cand.active]),
            )

        with jax.named_scope("sample"):
            # 2. one field-sampling pass: destination potential (despawn +
            # goal direction) and obstacle distance, four row gathers total.
            fs = sample_field(field_rows, map_h, map_w, ext.dest, ext.pos, cfg.field_unit)
            e = F.safe_normalize(fs.pot_grad)

            # Despawn: arrived (potential <= 0.25, sfm.rs:69) or out of grid
            # (neighbor_grid.rs:29 silently drops them; here the cell-id
            # sentinel doubles as the in-grid test so they deactivate instead
            # of sampling the 1e12 ring forever).
            not_arrived = ext.active & (fs.potential > phys.despawn_potential)
            cid = compute_cell_ids(ext.pos, not_arrived, cfg.grid)
            alive = cid < cfg.grid.n_cells
            n_exited = jnp.sum(not_arrived & ~alive).astype(jnp.int32)

        with jax.named_scope("sort"):
            # 3. cell-sort and truncate back to capacity; active agents sort to
            # the front (sentinel id for the rest), so truncation only ever
            # drops agents when the population exceeds capacity.  All per-agent
            # channels ride in ONE packed [*, 12] array so the permutation is a
            # single row gather.
            order = jnp.argsort(cid, stable=True)
            # Fault containment: a non-finite VELOCITY would poison the whole
            # 3x3 neighborhood through 0*NaN in the masked pair accumulate
            # (non-finite positions are already dead here: NaN fails the
            # despawn compare, inf fails the cell-id bound).  A huge finite
            # sentinel keeps the pair math finite — zero force (ellipse far
            # beyond cutoff), and the agent flings itself out of the grid on
            # integration, despawning counted next step.
            vel_f = jnp.where(jnp.abs(ext.vel) < 2.0**30, ext.vel, 2.0**30)
            # ... and a non-finite SPEED would NaN the goal force the same way
            # (speed reaches accel via (e*speed - vel)/tau); the sentinel makes
            # the agent fling itself out of the grid instead, counted.
            speed_f = jnp.where(jnp.abs(ext.speed) < 2.0**30, ext.speed, 2.0**30)
            packed = jnp.concatenate(
                [
                    ext.pos, vel_f, speed_f[:, None],
                    ext.dest.astype(jnp.float32)[:, None],
                    alive.astype(jnp.float32)[:, None],
                    e, fs.obs_dist[:, None], fs.obs_grad,
                ],
                axis=1,
            )
            sp = jnp.take(packed, order, axis=0, mode="clip")[:c]
            cid_sorted = jnp.take(cid, order, mode="clip")[:c]
            agents = AgentState(
                pos=sp[:, 0:2],
                vel=sp[:, 2:4],
                speed=sp[:, 4],
                dest=sp[:, 5].astype(jnp.int32),
                active=sp[:, 6] > 0.5,
            )
            e_s = sp[:, 7:9]
            n_alive_total = jnp.sum(alive).astype(jnp.int32)
            n_active = jnp.sum(agents.active).astype(jnp.int32)
            n_dropped = n_alive_total - n_active

        with jax.named_scope("local_forces"):
            # 4. forces: goal (sfm.rs:107-109) + obstacle (sfm.rs:188-237) +
            # pairwise via the dense cell layout (ops/forcepass.py).
            acc = F.goal_force(e_s, agents.vel, agents.speed, phys)
            if cfg.use_distance_map:
                acc = acc + F.obstacle_force(sp[:, 9], sp[:, 10:12], phys)
            elif obstacles[0].shape[0] > 0:
                acc = acc + F.segment_obstacle_force(agents.pos, *obstacles, phys)

        if cfg.use_neighbor_grid:
            with jax.named_scope("scatter"):
                layout = forcepass.build_layout(cid_sorted, agents.active,
                                                grid, k)
                data = forcepass.scatter_cell_data(layout, grid, k, agents.pos,
                                                   agents.vel, e_s)
            with jax.named_scope("pair"):
                acc_flat = forcepass.dense_pairwise(data, grid, k, phys)
            with jax.named_scope("gather"):
                acc = acc + forcepass.gather_pair_acc(acc_flat, layout)
            n_overflow = layout.n_overflow
            max_demand = layout.max_count
        else:
            with jax.named_scope("pair"):
                acc = acc + _all_pairs_acc(cfg, agents, e_s)
            n_overflow = max_demand = jnp.int32(0)

        # 5. integrate (sfm.rs:245-254).
        with jax.named_scope("integrate"):
            pos, vel = F.integrate(
                agents.pos, agents.vel, acc, agents.speed, agents.active, phys
            )
            agents = agents._replace(pos=pos, vel=vel)

        new_state = SimState(agents=agents, key=key, step=state.step + 1)
        metrics = StepMetrics(
            n_active=n_active,
            n_spawned=n_spawned,
            n_dropped=n_dropped,
            n_overflow=n_overflow,
            max_demand=max_demand,
            n_exited=n_exited,
        )
        return new_state, metrics

    return step
