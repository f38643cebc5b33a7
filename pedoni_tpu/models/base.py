"""Model abstraction — API parity with the reference's ``PedestrianModel``
trait (pedoni-simulator/src/models/mod.rs:13-25).

The functional core (models/sfm.py) is what runs on device; this layer
gives users of the reference the same five-method object surface:

    model = SocialForceModel(options, scenario, field)
    model.spawn_pedestrians(field, new_pedestrians)
    model.update_states(scenario, field)
    model.list_pedestrians()
    model.get_pedestrian_count()

``Pedestrian`` mirrors the exchange struct (models/mod.rs:29-32).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..field import Field, FieldMaps
from ..physics import Physics
from ..scenario import Scenario
from .sfm import (
    AgentState,
    SimState,
    StepConfig,
    device_inputs,
    make_initial_state,
    make_step,
)


@dataclasses.dataclass
class Pedestrian:
    """Exchange struct (models/mod.rs:29-32)."""

    pos: tuple[float, float]
    destination: int = 0


class PedestrianModel(abc.ABC):
    """The reference trait (models/mod.rs:13-25)."""

    @abc.abstractmethod
    def spawn_pedestrians(self, field: Field,
                          new_pedestrians: Sequence[Pedestrian]) -> None: ...

    @abc.abstractmethod
    def update_states(self, scenario: Scenario, field: Field) -> None: ...

    @abc.abstractmethod
    def list_pedestrians(self) -> list[Pedestrian]: ...

    @abc.abstractmethod
    def get_pedestrian_count(self) -> int: ...


class SocialForceModel(PedestrianModel):
    """Object-style wrapper over the functional device step.

    Note: the functional step fuses spawning into the device pipeline (one
    jitted function per step); this wrapper exists for drop-in familiarity and
    host-driven spawning.  ``update_states`` runs the fused step with
    periodic spawning disabled (externally injected agents only), matching
    the reference's split of spawn_pedestrians / update_states.
    """

    def __init__(self, options, scenario: Scenario, field: Field,
                 capacity: int = 4096, seed: int = 0) -> None:
        physics = getattr(options, "physics", None) or Physics()
        # External spawning only: strip ALL spawn groups from the step.
        # The reference trait ctor spawns nothing — the Simulator pushes
        # once-group pedestrians through spawn_pedestrians (lib.rs:37-52),
        # so seeding once-groups here too would double-spawn them for a
        # caller following the reference flow.
        bare = Scenario(
            size=scenario.size,
            waypoints=scenario.waypoints,
            obstacles=scenario.obstacles,
            pedestrians=(),
        )
        self.cfg = StepConfig.build(
            bare,
            physics=physics,
            capacity=capacity,
            neighbor_grid_unit=getattr(options, "neighbor_grid_unit", 1.4),
            field_unit=getattr(options, "field_grid_unit", 0.25),
            use_neighbor_grid=getattr(options, "use_neighbor_grid", True),
            use_distance_map=getattr(options, "use_distance_map", True),
        )
        self.maps = FieldMaps.from_field(field)
        dfield, self._obstacles = device_inputs(self.cfg, self.maps)
        self._field_rows = dfield.rows
        self._step = jax.jit(make_step(self.cfg, self.maps))
        self.state: SimState = make_initial_state(self.cfg, seed=seed)

    def spawn_pedestrians(self, field: Field,
                          new_pedestrians: Sequence[Pedestrian]) -> None:
        if not new_pedestrians:
            return
        a = self.state.agents
        active = np.array(a.active)  # writable copy
        free = np.nonzero(~active)[0]
        n = min(len(new_pedestrians), len(free))
        if n < len(new_pedestrians):
            import logging

            logging.getLogger(__name__).warning(
                "spawn overflow: dropping %d agents", len(new_pedestrians) - n
            )
        pos = np.asarray(a.pos).copy()
        dest = np.asarray(a.dest).copy()
        speed = np.asarray(a.speed).copy()
        vel = np.asarray(a.vel).copy()
        rng = np.random.default_rng(int(np.asarray(self.state.step)) + 1)
        for slot, p in zip(free[:n], new_pedestrians):
            pos[slot] = p.pos
            dest[slot] = p.destination
            vel[slot] = 0.0
            speed[slot] = max(rng.normal(self.cfg.physics.speed_mean,
                                         self.cfg.physics.speed_std), 0.1)
            active[slot] = True
        self.state = self.state._replace(
            agents=AgentState(
                pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                active=jnp.asarray(active),
            )
        )

    def update_states(self, scenario: Scenario, field: Field) -> None:
        self.state, self._metrics = self._step(
            self.state, self._field_rows, self._obstacles
        )

    def list_pedestrians(self) -> list[Pedestrian]:
        a = self.state.agents
        active = np.asarray(a.active)
        pos = np.asarray(a.pos)[active]
        dest = np.asarray(a.dest)[active]
        return [Pedestrian(pos=(float(p[0]), float(p[1])), destination=int(d))
                for p, d in zip(pos, dest)]

    def get_pedestrian_count(self) -> int:
        return int(np.asarray(self.state.agents.active).sum())
