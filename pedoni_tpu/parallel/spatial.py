"""Multi-device spatial sharding: strip decomposition + halo exchange.

The reference is strictly single-device (SURVEY.md section 2); this module is
the scaling axis it lacks.  The field is split into D vertical strips along
x over a 1D ``jax.sharding.Mesh``; each device owns the agents inside its
strip as a fixed-capacity SoA shard.  Each step, inside one
``shard_map``-ed function:

1. **spawn**    — every device samples the *same* candidate set from the same
                  PRNG key (replicated, no communication) and claims the
                  candidates that land in its strip.
2. **despawn**  — local potential / out-of-grid checks.
3. **exchange** — agents within the interaction cutoff (2 m = the halo
                  width, sfm.rs:133) of a strip boundary — plus any agents
                  that crossed it — are packed into fixed-size package
                  buffers and sent to the neighbor device with
                  ``lax.ppermute`` (a NCCL send/receive pair on GPUs).
                  Received agents
                  inside my strip are adopted (migration); the rest are
                  ghosts that only exert forces.
4. **forces**   — one cell-sort over owned + ghost agents on a local cell
                  window (strip + halo margin), dense 3x3 table, the same
                  force pass as the single-device step.
5. **compact**  — surviving owned agents cumsum-compact back into the
                  [capacity/D] shard (cell-sorted order preserved).

Determinism: owned agents near a boundary see exactly the same neighbor
set (local + ghosts) as a single device would, so a sharded run equals a
single-device run up to float reduction order.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..field import FieldMaps
from ..models.sfm import (
    AgentState,
    SimState,
    StepConfig,
    StepMetrics,
    _spawn_candidates,
    device_inputs,
)
from ..ops import forcepass, forces as F
from ..ops.neighbor import CellGrid
from ..ops.sampling import sample_field

AXIS = "x"

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    """Static layout of the strip decomposition."""

    base: StepConfig
    n_devices: int
    local_capacity: int  # capacity per device
    package_capacity: int  # max agents sent per direction per step
    halo: float  # halo width in meters (>= interaction cutoff)
    strip_width: float
    local_grid: CellGrid  # cell window covering strip + halo margin
    margin_cells: int

    @classmethod
    def build(cls, cfg: StepConfig, n_devices: int,
              package_capacity: int = 0) -> "ShardedConfig":
        if cfg.capacity % n_devices != 0:
            raise ValueError("capacity must divide by the device count")
        local_capacity = cfg.capacity // n_devices
        halo = cfg.physics.interaction_cutoff
        w, h = cfg.scenario.size
        strip_width = w / n_devices
        unit = cfg.grid.unit
        margin_cells = int(math.ceil(halo / unit)) + 1
        nx_local = int(math.ceil(strip_width / unit)) + 2 * margin_cells + 1
        local_grid = CellGrid(unit=unit, nx=nx_local, ny=cfg.grid.ny)
        if not package_capacity:
            package_capacity = max(32, local_capacity // 4)
        return cls(
            base=cfg,
            n_devices=n_devices,
            local_capacity=local_capacity,
            package_capacity=package_capacity,
            halo=halo,
            strip_width=strip_width,
            local_grid=local_grid,
            margin_cells=margin_cells,
        )


# Packed per-agent row layout used inside the sharded step: one [*, 12]
# f32 array so sorts / compactions / ppermutes are single-array row ops.
# Channels: 0:2 pos, 2:4 vel, 4 speed, 5 dest, 6 alive flag, 7:9 goal dir e,
# 9 obstacle distance, 10:12 obstacle-distance Sobel.
N_ROW = 12


def _compact_rows(mask: jnp.ndarray, capacity: int,
                  rows: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable-compact rows where ``mask`` into a [capacity, N_ROW] buffer
    (single scatter).  Returns (compacted, n_lost).  Order is preserved, so
    cell-sorted input stays cell-sorted."""
    dst = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dst = jnp.where(mask & (dst < capacity), dst, capacity)  # drop slot
    out = jnp.zeros((capacity + 1, rows.shape[1]), rows.dtype)
    out = out.at[dst].set(rows, mode="drop")[:capacity]
    n_lost = jnp.sum(mask) - jnp.minimum(jnp.sum(mask), capacity)
    return out, n_lost.astype(jnp.int32)


def _pack(pos, vel, speed, dest, alive, e, dist, dgrad) -> jnp.ndarray:
    return jnp.concatenate(
        [
            pos, vel, speed[:, None], dest.astype(jnp.float32)[:, None],
            alive.astype(jnp.float32)[:, None], e, dist[:, None], dgrad,
        ],
        axis=1,
    )


def _unpack_agents(rows: jnp.ndarray) -> AgentState:
    return AgentState(
        pos=rows[:, 0:2],
        vel=rows[:, 2:4],
        speed=rows[:, 4],
        dest=rows[:, 5].astype(jnp.int32),
        active=rows[:, 6] > 0.5,
    )


def make_sharded_step(scfg: ShardedConfig, maps: FieldMaps, mesh: Mesh):
    """Build the sharded step: SimState (agents sharded on axis 0) ->
    (SimState, StepMetrics replicated)."""
    cfg = scfg.base
    phys = cfg.physics
    d_count = scfg.n_devices
    cl = scfg.local_capacity
    pk = scfg.package_capacity
    unit = cfg.grid.unit

    # Global grid (for the despawn out-of-grid check, identical semantics to
    # the single-chip path / neighbor_grid.rs:29).
    gx_cells, gy_cells = cfg.grid.nx, cfg.grid.ny

    def local_cell_ids(pos, ok, cx0):
        # The local window is the global grid's columns cx0.. — same cell
        # boundaries, hence the same 3x3 neighbor sets as one device.
        cx = jnp.floor(pos[:, 0] / unit).astype(jnp.int32) - cx0
        cy = jnp.floor(pos[:, 1] / unit).astype(jnp.int32)
        g = scfg.local_grid
        in_grid = (cx >= 0) & (cx < g.nx) & (cy >= 0) & (cy < g.ny)
        return jnp.where(ok & in_grid, cy * g.nx + cx, g.n_cells).astype(jnp.int32)

    # Static padded-map dims (see models/sfm.py: the field rides as a jit
    # ARGUMENT, never a baked constant).
    from ..field import PAD

    map_h = int(math.ceil(cfg.scenario.size[1] / cfg.field_unit)) + 2 * PAD
    map_w = int(math.ceil(cfg.scenario.size[0] / cfg.field_unit)) + 2 * PAD

    def step_local(agents: AgentState, key, step_idx, field_rows, obstacles):
        d = jax.lax.axis_index(AXIS)
        x_lo = d.astype(jnp.float32) * scfg.strip_width
        x_hi = x_lo + scfg.strip_width
        # Last strip claims everything to the right as well.
        claim_hi = jnp.where(d == d_count - 1, jnp.float32(1e30), x_hi)

        key, k_spawn = jax.random.split(key)

        # 1. spawn: identical candidates everywhere (same replicated PRNG
        # key -> no communication); claim the ones in my strip.
        cand = _spawn_candidates(cfg, k_spawn)
        in_strip = (cand.pos[:, 0] >= x_lo) & (cand.pos[:, 0] < claim_hi)
        cand_active = cand.active & in_strip
        n_spawned = jnp.sum(cand_active).astype(jnp.int32)

        pos = jnp.concatenate([agents.pos, cand.pos])
        vel = jnp.concatenate([agents.vel, cand.vel])
        speed = jnp.concatenate([agents.speed, cand.speed])
        dest = jnp.concatenate([agents.dest, cand.dest])
        active = jnp.concatenate([agents.active, cand_active])

        # 2. one field-sampling pass (4 row gathers): despawn check + goal
        # direction + obstacle terms.  Sampled values ride in the packed
        # rows through the exchange, so receivers never resample.
        fs = sample_field(field_rows, map_h, map_w, dest, pos, cfg.field_unit)
        e = F.safe_normalize(fs.pot_grad)
        gx = jnp.floor(pos[:, 0] / unit).astype(jnp.int32)
        gy = jnp.floor(pos[:, 1] / unit).astype(jnp.int32)
        in_global = (gx >= 0) & (gx < gx_cells) & (gy >= 0) & (gy < gy_cells)
        not_arrived = active & (fs.potential > phys.despawn_potential)
        alive = not_arrived & in_global
        n_exited = jnp.sum(not_arrived & ~in_global).astype(jnp.int32)

        rows = _pack(pos, vel, speed, dest, alive, e, fs.obs_dist, fs.obs_grad)

        # 3. exchange: halo agents + emigrants, both directions, one packed
        # ppermute per direction.  Emigrants (agents that crossed the strip
        # boundary) pack FIRST; halo ghosts fill what's left.  If the
        # package saturates, unsent emigrants stay alive locally and retry
        # next step (the local window's margin still gives them forces) —
        # agents are never silently destroyed; the shortfall is reported
        # in n_deferred.
        x = pos[:, 0]
        stays = (x >= x_lo) & (x < claim_hi)
        emig_l = alive & ~stays & (x < x_lo)
        emig_r = alive & ~stays & (x >= x_lo)
        ghost_l = alive & stays & (x < x_lo + scfg.halo)
        ghost_r = alive & stays & (x >= x_hi - scfg.halo)

        def pack_priority(emig, ghost):
            """Compact emigrants first, then ghosts, into [pk] rows.
            Returns (package, shipped_emigrant_mask, n_ghost_lost)."""
            n_emig = jnp.sum(emig.astype(jnp.int32))
            dst_e = jnp.cumsum(emig.astype(jnp.int32)) - 1
            dst_g = n_emig + jnp.cumsum(ghost.astype(jnp.int32)) - 1
            dst = jnp.where(emig, dst_e, jnp.where(ghost, dst_g, pk))
            dst = jnp.where(dst < pk, dst, pk)
            out = jnp.zeros((pk + 1, rows.shape[1]), rows.dtype)
            out = out.at[dst].set(rows, mode="drop")[:pk]
            shipped = emig & (dst_e < pk)
            n_ghost_lost = jnp.sum(ghost & (dst_g >= pk)).astype(jnp.int32)
            return out, shipped, n_ghost_lost

        pkg_l, shipped_l, lost_gl = pack_priority(emig_l, ghost_l)
        pkg_r, shipped_r, lost_gr = pack_priority(emig_r, ghost_r)

        right_perm = [(i, i + 1) for i in range(d_count - 1)]
        left_perm = [(i, i - 1) for i in range(1, d_count)]

        def pperm(pkg, perm):
            if not perm:
                return jnp.zeros_like(pkg)
            return jax.lax.ppermute(pkg, AXIS, perm)

        recv_l = pperm(pkg_r, right_perm)  # from my left neighbor
        recv_r = pperm(pkg_l, left_perm)  # from my right neighbor

        # Give up only the emigrants that actually shipped.  They stay in
        # this device's force pass as ghosts: its agents near the boundary
        # still feel them this step, as on one device.
        n_deferred = (jnp.sum(emig_l & ~shipped_l)
                      + jnp.sum(emig_r & ~shipped_r)).astype(jnp.int32)
        keep_local = stays | ~(shipped_l | shipped_r)

        def owned_mask(recv):
            rx = recv[:, 0]
            return (rx >= x_lo) & (rx < claim_hi)  # adopted; else ghost

        # 4. one combined cell-sort over owned + adopted + ghosts.
        work = jnp.concatenate([rows, recv_l, recv_r])
        owned = jnp.concatenate([
            keep_local,
            owned_mask(recv_l),
            owned_mask(recv_r),
        ])

        cx0 = jnp.floor(x_lo / unit).astype(jnp.int32) - scfg.margin_cells
        w_alive = work[:, 6] > 0.5
        cid = local_cell_ids(work[:, 0:2], w_alive, cx0)
        order = jnp.argsort(cid, stable=True)
        work = jnp.take(work, order, axis=0, mode="clip")
        owned = jnp.take(owned, order, mode="clip")
        cid_sorted = jnp.take(cid, order, mode="clip")

        # Force pass: same dense cell-layout primitives as the single-chip
        # path (ops/forcepass.py), over the local strip+halo window.
        w = _unpack_agents(work)
        e_s = work[:, 7:9]
        acc = F.goal_force(e_s, w.vel, w.speed, phys)
        if cfg.use_distance_map:
            acc = acc + F.obstacle_force(work[:, 9], work[:, 10:12], phys)
        elif obstacles[0].shape[0] > 0:
            acc = acc + F.segment_obstacle_force(w.pos, *obstacles, phys)

        lgrid = scfg.local_grid
        layout = forcepass.build_layout(
            cid_sorted, w.active, lgrid, cfg.table_capacity
        )
        data = forcepass.scatter_cell_data(
            layout, lgrid, cfg.table_capacity, w.pos, w.vel, e_s
        )
        acc_flat = forcepass.dense_pairwise(
            data, lgrid, cfg.table_capacity, phys
        )
        acc = acc + forcepass.gather_pair_acc(acc_flat, layout)

        pos_new, vel_new = F.integrate(w.pos, w.vel, acc, w.speed, w.active, phys)
        work = jnp.concatenate([pos_new, vel_new, work[:, 4:]], axis=1)

        # 5. compact owned survivors back into the local shard.
        keep = owned & w.active
        out_rows, n_lost = _compact_rows(keep, cl, work)
        agents_out = _unpack_agents(out_rows)

        n_active = jnp.sum(agents_out.active).astype(jnp.int32)
        metrics = StepMetrics(
            n_active=jax.lax.psum(n_active, AXIS),
            n_spawned=jax.lax.psum(n_spawned, AXIS),
            n_dropped=jax.lax.psum(n_lost, AXIS),
            n_overflow=jax.lax.psum(layout.n_overflow, AXIS),
            max_demand=jax.lax.pmax(layout.max_count, AXIS),
            n_exited=jax.lax.psum(n_exited, AXIS),
            # package saturation: deferred emigrants (alive, retrying) and
            # truncated ghosts (missing halo forces this step) — visible,
            # never silent.
            n_deferred=jax.lax.psum(n_deferred + lost_gl + lost_gr, AXIS),
        )
        return agents_out, key, step_idx + 1, metrics

    sharded = jax.shard_map(
        step_local,
        mesh=mesh,
        in_specs=(P(AXIS), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=False,
    )

    def step(state: SimState, field_rows, obstacles):
        agents, key, step_idx, metrics = sharded(
            state.agents, state.key, state.step, field_rows, obstacles
        )
        return SimState(agents=agents, key=key, step=step_idx), metrics

    return step


def shard_state(scfg: ShardedConfig, mesh: Mesh, state: SimState) -> SimState:
    """Place a flat (unsharded) state on the mesh: each active agent moves
    to a free slot of the shard that owns its strip, so a state from any
    device count (or a checkpoint) continues on this one.  Agents past a
    full shard are dropped with a warning."""
    cl = scfg.local_capacity
    arrays = {k: np.asarray(getattr(state.agents, k))
              for k in AgentState._fields}
    idx = np.flatnonzero(arrays["active"])
    strip = np.clip((arrays["pos"][idx, 0] / scfg.strip_width).astype(np.int64),
                    0, scfg.n_devices - 1)
    order = np.argsort(strip, kind="stable")
    idx, strip = idx[order], strip[order]
    first = np.searchsorted(strip, np.arange(scfg.n_devices))
    rank = np.arange(len(idx)) - first[strip]
    fits = rank < cl
    if not fits.all():
        log.warning("shard placement dropped %d agents (strip shard full)",
                    int((~fits).sum()))
    src, slot = idx[fits], strip[fits] * cl + rank[fits]

    sharding = NamedSharding(mesh, P(AXIS))
    out = {}
    for k, v in arrays.items():
        o = np.zeros((scfg.base.capacity,) + v.shape[1:], v.dtype)
        if k == "speed":
            o[:] = 1.0
        o[slot] = v[src]
        out[k] = jax.device_put(o, sharding)
    rep = NamedSharding(mesh, P())
    return SimState(
        agents=AgentState(**out),
        key=jax.device_put(state.key, rep),
        step=jax.device_put(jnp.asarray(state.step, jnp.int32), rep),
    )


def dryrun(n_devices: int, devices=None) -> None:
    """Build an n-device mesh over ``devices`` (default: the process's own),
    jit the full sharded step, run three steps on tiny shapes, and
    sanity-check the result."""
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < n_devices:
        raise ValueError(f"dryrun({n_devices}) needs {n_devices} devices, "
                         f"{len(devices)} given")
    mesh = Mesh(np.array(devices[:n_devices]), (AXIS,))

    from ..field import Field, FieldMaps
    from ..models.sfm import make_initial_state
    from ..scenario import loads_scenario

    scenario = loads_scenario(
        """
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
spawn = { kind = "periodic", frequency = 8.0 }
[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "once", count = 40 }
"""
    )
    field = Field.from_scenario(scenario, unit=0.25)
    maps = FieldMaps.from_field(field)
    cfg = StepConfig.build(scenario, capacity=128 * n_devices, table_capacity=8)
    scfg = ShardedConfig.build(cfg, n_devices, package_capacity=32)
    step = jax.jit(make_sharded_step(scfg, maps, mesh))
    state = shard_state(scfg, mesh, make_initial_state(cfg, seed=0))
    dfield, obstacles = device_inputs(cfg, maps)

    for _ in range(3):
        state, metrics = step(state, dfield.rows, obstacles)
        # Lockstep each step: virtual CPU meshes on few-core hosts can
        # starve the collective rendezvous under deep dispatch queues.
        jax.block_until_ready(state)
    n = int(metrics.n_active)
    if not 0 < n <= cfg.capacity:
        raise RuntimeError(f"implausible active count {n}")
    if not np.isfinite(np.asarray(state.agents.pos)).all():
        raise RuntimeError("non-finite positions after sharded step")
