"""Checkpoint / resume (the reference has none — SURVEY.md section 5).

Simulation state is a handful of SoA arrays plus the PRNG key and step
counter, so a checkpoint is a plain ``.npz`` dump.  Useful for long
million-agent runs and for exact-resume determinism tests.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .models.sfm import AgentState, SimState

FORMAT_VERSION = 1


def save_state(state: SimState, path: str | Path, step_count: int = 0) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    a = state.agents
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        pos=np.asarray(a.pos),
        vel=np.asarray(a.vel),
        speed=np.asarray(a.speed),
        dest=np.asarray(a.dest),
        active=np.asarray(a.active),
        key=np.asarray(state.key),
        step=np.asarray(state.step),
        step_count=step_count,
    )


def load_state(path: str | Path) -> tuple[SimState, int]:
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        agents = AgentState(
            pos=jnp.asarray(z["pos"]),
            vel=jnp.asarray(z["vel"]),
            speed=jnp.asarray(z["speed"]),
            dest=jnp.asarray(z["dest"]),
            active=jnp.asarray(z["active"]),
        )
        state = SimState(
            agents=agents,
            key=jnp.asarray(z["key"]),
            step=jnp.asarray(z["step"]),
        )
        return state, int(z["step_count"])


def save(sim, path: str | Path) -> None:
    """Checkpoint a Simulator.  Always stored as flat agent arrays, so a
    checkpoint written at any device count restores on any other."""
    save_state(sim.state, path, step_count=sim.step_count)


def restore(sim, path: str | Path) -> None:
    """Restore a Simulator in place.  A checkpoint larger than the
    simulator's capacity rebuilds it at the checkpoint's capacity; smaller
    checkpoints are padded with inactive slots."""
    state, step_count = load_state(path)
    sim.set_state(state, step_count)
