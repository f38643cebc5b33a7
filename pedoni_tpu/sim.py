"""Simulator orchestration: state management, capacity growth, ticking.

The host-side owner of the device state — the analog of the reference's
``Simulator`` (lib.rs:17-105), with the same surface:

    sim = Simulator(options, scenario)
    metrics = sim.tick()
    agents = sim.list_pedestrians()
    sim.pedestrian_count

Accelerator specifics the reference never needed:

- **Fixed capacity + bucketed growth.** XLA wants static shapes, so agent
  arrays have a fixed capacity; when the active population nears it, the
  arrays are padded to double size and the step re-jits (a rare, amortized
  recompile).  The per-cell neighbor table K grows the same way, before
  the fullest cell reaches it.
- **Async metrics.** ``tick`` returns numbers the moment the host needs
  them; ``run`` variants keep metrics on device to avoid per-step syncs.
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .diagnostics import DiagnosticLog, StepRecord
from .field import Field, FieldMaps
from .models.sfm import (
    AgentState,
    SimState,
    StepConfig,
    _spawn_candidates,
    device_inputs,
    make_initial_state,
    make_step,
)
from .physics import Physics
from .scenario import Scenario
from .utils.timing import Timer

log = logging.getLogger(__name__)


@jax.jit
def _accumulate_metrics(tot, m):
    """Device-side running totals for Simulator.run(): counters sum,
    max_demand takes the max, n_active keeps the latest (it is a level,
    not a flow).  One fused scalar kernel per step — run() stays
    sync-free but no step's overflow/drop count is ever lost."""
    return m._replace(
        n_spawned=tot.n_spawned + m.n_spawned,
        n_dropped=tot.n_dropped + m.n_dropped,
        n_overflow=tot.n_overflow + m.n_overflow,
        max_demand=jnp.maximum(tot.max_demand, m.max_demand),
        n_exited=tot.n_exited + m.n_exited,
        n_deferred=tot.n_deferred + m.n_deferred,
    )


@dataclasses.dataclass(frozen=True)
class SimulatorOptions:
    """Counterpart of lib.rs:109-135 with the same defaults."""

    neighbor_grid_unit: float = 1.4
    field_grid_unit: float = 0.25
    use_neighbor_grid: bool = True
    use_distance_map: bool = True
    table_capacity: int = 16  # initial agents per neighbor cell; grows
    capacity: int = 0  # 0 = auto-size from the scenario
    seed: int = 0
    physics: Physics = Physics()
    n_devices: int = 1  # >1 = spatial sharding over x strips


def _pad_agents(a: AgentState, capacity: int) -> AgentState:
    """Flat agent arrays padded with inactive slots up to ``capacity``."""
    pad = capacity - a.pos.shape[0]
    if pad <= 0:
        return a
    return AgentState(
        pos=np.concatenate([np.asarray(a.pos), np.zeros((pad, 2), np.float32)]),
        vel=np.concatenate([np.asarray(a.vel), np.zeros((pad, 2), np.float32)]),
        speed=np.concatenate([np.asarray(a.speed), np.ones((pad,), np.float32)]),
        dest=np.concatenate([np.asarray(a.dest), np.zeros((pad,), np.int32)]),
        active=np.concatenate([np.asarray(a.active), np.zeros((pad,), bool)]),
    )


class Simulator:
    def __init__(self, options: SimulatorOptions, scenario: Scenario) -> None:
        if options.n_devices > 1 and not options.use_neighbor_grid:
            raise ValueError("all-pairs mode (no neighbor grid) runs on one "
                             "device; drop --devices or the flag")
        self.options = options
        self.scenario = scenario

        with Timer() as t_field:
            self.field = Field.from_scenario(scenario, options.field_grid_unit)
            self.maps = FieldMaps.from_field(self.field)
        self.time_calc_field = t_field.elapsed
        log.info(
            "field: %dx%d cells, %d potential maps, built in %.3fs",
            *self.field.shape, len(scenario.waypoints), t_field.elapsed,
        )

        capacity = options.capacity or self._auto_capacity(scenario)
        self._build(capacity)
        self.state = self._from_flat_state(
            make_initial_state(self.cfg, seed=options.seed))
        self.step_count = 0
        self.last_metrics = None      # host StepMetrics of the last tick()
        self.last_run_metrics = None  # totals of the latest run() call

    @staticmethod
    def _auto_capacity(scenario: Scenario) -> int:
        n_once = sum(g.spawn.count for g in scenario.once_groups)
        rate = sum(g.spawn.frequency for g in scenario.periodic_groups)
        estimate = int(n_once * 1.25 + rate * 60 + 1024)
        cap = 1024
        while cap < estimate:
            cap *= 2
        return cap

    def _devices(self) -> list:
        """Devices of the default platform (``-b cpu`` pins it)."""
        default = jax.config.jax_default_device
        if default is None:
            return jax.devices()
        if isinstance(default, str):
            return jax.devices(default)
        return jax.devices(default.platform)

    def _build(self, capacity: int) -> None:
        o = self.options
        d = o.n_devices
        capacity = -(-capacity // d) * d  # shards need equal slabs
        self._spawn_chain = None  # traces self.cfg, rebuilt with it
        self.cfg = StepConfig.build(
            self.scenario,
            physics=o.physics,
            capacity=capacity,
            neighbor_grid_unit=o.neighbor_grid_unit,
            field_unit=o.field_grid_unit,
            table_capacity=o.table_capacity,
            use_neighbor_grid=o.use_neighbor_grid,
            use_distance_map=o.use_distance_map,
        )
        field, obstacles = device_inputs(self.cfg, self.maps)
        self._field_rows = field.rows
        self._obstacles = obstacles
        if d > 1:
            from .parallel import spatial

            devices = self._devices()
            if len(devices) < d:
                raise ValueError(
                    f"--devices {d} but only {len(devices)} devices are "
                    "visible")
            self._mesh = Mesh(np.array(devices[:d]), (spatial.AXIS,))
            # Replicate the field once; left on one device, every call
            # would copy it to the others.
            self._field_rows, self._obstacles = jax.device_put(
                (self._field_rows, self._obstacles),
                NamedSharding(self._mesh, P()))
            self._scfg = spatial.ShardedConfig.build(self.cfg, d)
            self._step = jax.jit(spatial.make_sharded_step(
                self._scfg, self.maps, self._mesh))
        else:
            self._mesh = self._scfg = None
            self._step = jax.jit(make_step(self.cfg, self.maps))
        log.info("step function built: capacity=%d K=%d devices=%d",
                 self.cfg.capacity, o.table_capacity, d)

    def _grow(self) -> None:
        old_cap = self.cfg.capacity
        flat = self.state
        self._build(old_cap * 2)
        self.state = self._from_flat_state(flat._replace(
            agents=_pad_agents(flat.agents, self.cfg.capacity)))
        log.info("capacity grown: %d -> %d", old_cap, self.cfg.capacity)

    def _grow_if_needed(self, m) -> bool:
        """Growth rules on one step's host metrics; True if state was
        rebuilt.  The table grows when the fullest cell is one agent short
        of K (drop-free: cells gain at most a few agents per step), the
        agent arrays double at 80% occupancy when the scenario spawns
        (without spawn sources the population cannot grow)."""
        if (self.options.use_neighbor_grid
                and int(m.max_demand) >= self.options.table_capacity - 1):
            self._grow_table(int(m.n_overflow))
            return True
        if self.cfg.spawn.total and int(m.n_active) > 0.8 * self.cfg.capacity:
            self._grow()
            return True
        return False

    def tick(self) -> StepRecord:
        """Advance one step (lib.rs:64-100) and return host-side metrics."""
        with Timer() as t:
            self.state, dmetrics = self._step(self.state, self._field_rows, self._obstacles)
            # ONE batched device->host transfer for all metric scalars.
            metrics = jax.device_get(dmetrics)
            n_active = int(metrics.n_active)
        self.step_count += 1
        self.last_metrics = metrics  # full host-side StepMetrics

        n_dropped = int(metrics.n_dropped)
        if n_dropped > 0:
            log.warning("step %d: %d agents dropped at capacity",
                        self.step_count, n_dropped)
        if int(metrics.n_deferred) > 0:
            log.warning("step %d: %d agents deferred by full exchange "
                        "packages", self.step_count, int(metrics.n_deferred))
        n_exited = int(metrics.n_exited)
        if n_exited > 0:
            # Expected departure (the reference drops off-grid agents
            # silently, neighbor_grid.rs:29) — informational only.
            log.debug("step %d: %d agents left the field",
                      self.step_count, n_exited)
        self._grow_if_needed(metrics)

        return StepRecord(
            active_ped_count=n_active,
            time_spawn=0.0,
            time_calc_state=t.elapsed,
        )

    def run(self, n_steps: int, sync_every: int = 0,
            guard_every: int = 4) -> StepRecord:
        """Advance ``n_steps`` without per-step host syncs (throughput
        mode): metrics accumulate ON DEVICE (sums; max of max_demand) and
        are fetched once at the end, so no step's counters are ever lost
        — the totals land in :attr:`last_run_metrics` and loss warnings
        fire exactly as in tick().

        Growth runs drop-free like tick() even with ``sync_every=0``:
        every ``guard_every`` steps the LAGGED metrics of the step
        ``guard_every`` dispatches ago are fetched (that step has long
        resolved, so the fetch does not drain the dispatch queue) and
        tick()'s growth rules apply.  The lag means a cell sprinting from
        below K-1 past K within ``guard_every`` steps still overflows,
        counted, exactly tick()'s own caveat; set ``guard_every=0`` to
        trade the guard away for zero mid-run fetches.  ``sync_every`` > 0
        additionally bounds the dispatch queue with full syncs."""
        totals = None
        metrics = None
        pending: list = []  # metrics of the last guard_every steps
        with Timer() as t:
            for i in range(n_steps):
                self.state, metrics = self._step(
                    self.state, self._field_rows, self._obstacles
                )
                # One tiny fused device op per step (scalar adds/max) —
                # dispatch stays async, nothing syncs until the end.
                totals = metrics if totals is None \
                    else _accumulate_metrics(totals, metrics)
                if guard_every:
                    pending.append(metrics)
                    if len(pending) > guard_every:
                        pending.pop(0)
                    if (i + 1) % guard_every == 0:
                        old = pending[0]  # resolved guard_every-1 steps ago
                        if self._grow_if_needed(jax.device_get(old)):
                            pending.clear()
                if sync_every and (i + 1) % sync_every == 0:
                    if not self._grow_if_needed(jax.device_get(metrics)):
                        jax.block_until_ready(self.state)
            totals = jax.device_get(totals) if totals is not None else None
            n_active = int(totals.n_active) if totals is not None else 0
        self.step_count += n_steps
        self.last_run_metrics = totals
        if totals is not None:
            if int(totals.n_dropped) > 0:
                log.warning("run(%d): %d agents dropped at capacity over "
                            "the run", n_steps, int(totals.n_dropped))
            if int(totals.n_overflow) > 0:
                log.warning("run(%d): %d agent-steps without pair forces "
                            "(full cells) over the run", n_steps,
                            int(totals.n_overflow))
            if int(totals.n_deferred) > 0:
                log.warning("run(%d): %d agent-steps deferred by full "
                            "exchange packages over the run", n_steps,
                            int(totals.n_deferred))
        return StepRecord(
            active_ped_count=n_active,
            time_spawn=0.0,
            time_calc_state=t.elapsed / max(n_steps, 1),
        )

    def _grow_table(self, n_lost: int) -> None:
        """Grow the per-cell table K and rebuild the step.

        Called preemptively (n_lost == 0) when peak demand reaches K-1 —
        no agent has lost its pair forces — or after a cell actually
        overflowed (those agents' pair forces that step are counted)."""
        old_k = self.options.table_capacity
        flat = self.state
        self.options = dataclasses.replace(
            self.options, table_capacity=old_k + max(4, old_k // 2)
        )
        if n_lost:
            log.warning(
                "step %d: %d agents found their cell full; growing "
                "table_capacity %d -> %d",
                self.step_count, n_lost, old_k, self.options.table_capacity,
            )
        else:
            log.info(
                "step %d: peak cell demand reached %d; growing "
                "table_capacity %d -> %d preemptively (drop-free)",
                self.step_count, old_k - 1, old_k, self.options.table_capacity,
            )
        self._build(self.cfg.capacity)
        self.state = self._from_flat_state(flat)

    def measure_kernel_time(self, n: int = 10) -> float:
        """Device time (seconds/step) of the step alone — the
        ``time_calc_state_kernel`` diagnostic slot (the reference measured
        this and threw it away, sfm_gpu.rs:229-236).  Chains the step n
        times from the current state, without per-step metric fetches,
        fenced by ``block_until_ready``; the simulation does not advance."""
        s = self.state
        jax.block_until_ready(s)
        with Timer() as t:
            for _ in range(n):
                s, _ = self._step(s, self._field_rows, self._obstacles)
            jax.block_until_ready(s)
        return t.elapsed / n

    def measure_spawn_time(self, n: int = 10) -> float:
        """Device time (seconds) of the spawn-candidate sampling alone —
        the ``time_spawn`` diagnostic slot.  The reference times its
        host-side spawn loop every step (lib.rs:68-74, diagnostic.rs:45);
        our spawn is fused into the device step, so this isolates it the
        same way :meth:`measure_kernel_time` does.  0.0 when the scenario
        has no spawn sources."""
        if self.cfg.spawn.total == 0:
            return 0.0
        if self._spawn_chain is None:
            cfg = self.cfg
            self._spawn_chain = jax.jit(lambda key: _spawn_candidates(cfg, key))
        key = self.state.key
        jax.block_until_ready(self._spawn_chain(key))  # compile
        with Timer() as t:
            for _ in range(n):
                out = self._spawn_chain(key)
            jax.block_until_ready(out)
        return t.elapsed / n

    def _from_flat_state(self, state: SimState) -> SimState:
        """Place a flat state for this simulator's device count — so
        checkpoints restore across device counts.  ``self.state`` itself
        is always flat: a sharded state's global arrays hold strip d's
        agents in slab d."""
        if self._mesh is not None:
            from .parallel import spatial

            return spatial.shard_state(self._scfg, self._mesh, state)
        return jax.tree.map(jnp.asarray, state)

    def set_state(self, state: SimState, step_count: int = 0) -> None:
        """Continue from a flat state of any capacity (a checkpoint, or a
        state built by hand): the step is rebuilt at the larger capacity if
        needed, and smaller states are padded with inactive slots."""
        n = state.agents.pos.shape[0]
        if n > self.cfg.capacity:
            self._build(n)
        self.state = self._from_flat_state(state._replace(
            agents=_pad_agents(state.agents, self.cfg.capacity)))
        self.step_count = step_count

    def list_pedestrians(self) -> tuple[np.ndarray, np.ndarray]:
        """Positions [n, 2] and destinations [n] of active agents
        (models/mod.rs:29-32 exchange struct analog)."""
        a = self.state.agents
        active = np.asarray(a.active)
        return np.asarray(a.pos)[active], np.asarray(a.dest)[active]

    @property
    def pedestrian_count(self) -> int:
        return int(np.asarray(self.state.agents.active).sum())

    def new_log(self, scenario_name: str = "") -> DiagnosticLog:
        platform = self._devices()[0].platform
        lg = DiagnosticLog(model=f"sfm/{platform}x{self.options.n_devices}",
                           scenario=scenario_name)
        lg.time_calc_field = self.time_calc_field
        return lg
