#!/usr/bin/env python
"""Headline benchmark: agent-steps/second on one GPU at 1M agents.

Synthetic dense crowd (the workload class of the reference's generated
random/sparse scenarios, scaled to the BASELINE.json north star): N agents
uniformly placed on a square open field, all walking toward a goal edge,
full physics (goal + pairwise + obstacle forces, cell sort, despawn
checks).  The state is handed to a ``Simulator`` and advanced with
``Simulator.run``, the throughput loop users run.

Prints ONE JSON line:
    {"metric": "agent_steps_per_sec", "value": ..., "unit": "agent-steps/s",
     "vs_baseline": value / 1e9, "device": {...}, ...}

The baseline denominator is the 1e9 agent-steps/s per device target from
BASELINE.json (the Rust reference publishes no numbers; see BASELINE.md).
The bench refuses any device that is not a GPU unless ``--allow-cpu`` is
given, and every record names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def card_info() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them,
    read from a child process that does not touch JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "not available"


def device_record() -> dict:
    """What the measurement ran on: JAX's view plus the card's own."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_info() if devs[0].platform == "gpu" else "none",
    }


def build_problem(n_agents: int, density: float, seed: int,
                  waypoints: int = 1):
    """The bench workload: (scenario, flat SimState).

    A square field of area ``n_agents / density`` with one goal edge (or W
    horizontal exit bands with nearest-exit assignment, evacuation.toml's
    shape, scaled) and one wall segment; agents uniform over the field."""
    import jax
    import jax.numpy as jnp

    from pedoni_tpu.models.sfm import AgentState, SimState
    from pedoni_tpu.scenario import Scenario, Segment

    w = h = float(np.sqrt(n_agents / density))
    ys = np.linspace(1.0, h - 1.0, waypoints + 1)
    scenario = Scenario(
        size=(w, h),
        waypoints=tuple(
            Segment(line=((1.0, float(ys[i])), (1.0, float(ys[i + 1]))),
                    width=1.0)
            for i in range(waypoints)),
        obstacles=(
            Segment(line=((w / 2, h / 4), (w / 2, h / 2)), width=2.0),
        ),
        pedestrians=(),
    )

    capacity = 1
    while capacity < n_agents:
        capacity *= 2
    rng = np.random.default_rng(seed)
    pos = np.stack([
        rng.uniform(2.0, w - 2.0, size=capacity),
        rng.uniform(2.0, h - 2.0, size=capacity),
    ], axis=1).astype(np.float32)
    vel = np.zeros((capacity, 2), np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, capacity), 0.1, None).astype(np.float32)
    if waypoints > 1:
        dest = np.clip(
            np.searchsorted(ys[1:-1], pos[:, 1]), 0, waypoints - 1
        ).astype(np.int32)
    else:
        dest = np.zeros((capacity,), np.int32)
    active = np.zeros((capacity,), bool)
    active[:n_agents] = True

    agents = AgentState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), speed=jnp.asarray(speed),
        dest=jnp.asarray(dest), active=jnp.asarray(active),
    )
    state = SimState(agents=agents, key=jax.random.PRNGKey(seed),
                     step=jnp.int32(0))
    return scenario, state


def make_bench_simulator(n_agents: int, density: float, seed: int,
                         waypoints: int = 1, table_capacity: int = 16,
                         n_devices: int = 1):
    """A Simulator holding the bench problem's state."""
    from pedoni_tpu import Simulator, SimulatorOptions

    scenario, state = build_problem(n_agents, density, seed, waypoints)
    sim = Simulator(SimulatorOptions(
        capacity=state.agents.pos.shape[0], table_capacity=table_capacity,
        seed=seed, n_devices=n_devices), scenario)
    sim.set_state(state)
    return sim


def timed_windows(sim, n_windows: int, window: int) -> list[float]:
    """Seconds per step of ``n_windows`` runs of ``window`` steps, each
    ending in ``block_until_ready`` on the state."""
    import jax

    times = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        sim.run(window)
        jax.block_until_ready(sim.state)
        times.append((time.perf_counter() - t0) / window)
    return times


def capture(args) -> dict:
    """Build + measure one configuration; returns the record dict."""
    import jax

    t0 = time.perf_counter()
    sim = make_bench_simulator(args.agents, args.density, args.seed,
                               args.waypoints, args.table_capacity)
    sim.run(args.warmup)
    jax.block_until_ready(sim.state)
    setup_s = time.perf_counter() - t0
    if args.verbose:
        print(f"# setup + warmup({args.warmup}): {setup_s:.1f}s, "
              f"capacity={sim.cfg.capacity}, K={sim.cfg.table_capacity}",
              file=sys.stderr)

    window = max(1, args.steps // args.windows)
    k_before = sim.cfg.table_capacity
    times = timed_windows(sim, args.windows, window)
    n_active = int(sim.last_run_metrics.n_active)
    med = statistics.median(times)
    agent_steps = n_active / med
    if args.verbose:
        print(f"# {med * 1e3:.3f} ms/step median of {args.windows} x "
              f"{window} steps (min {min(times) * 1e3:.3f}, max "
              f"{max(times) * 1e3:.3f}), active={n_active}", file=sys.stderr)
    return {
        "metric": "agent_steps_per_sec",
        "value": agent_steps,
        "unit": "agent-steps/s",
        "vs_baseline": agent_steps / 1e9,
        "device": device_record(),
        "ms_per_step": med * 1e3,
        "ms_per_step_min": min(times) * 1e3,
        "ms_per_step_max": max(times) * 1e3,
        "method": f"median of {args.windows} windows x {window} steps, "
                  "each ending in block_until_ready",
        "n_active": n_active,
        "agents": args.agents,
        "waypoints": args.waypoints,
        "table_capacity": sim.cfg.table_capacity,
        "rebuilt_in_window": sim.cfg.table_capacity != k_before,
        "setup_s": setup_s,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1_000_000)
    ap.add_argument("--density", type=float, default=2.5, help="agents per m^2")
    ap.add_argument("--steps", type=int, default=100, help="timed steps")
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows the steps are split into")
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--table-capacity", type=int, default=16,
                    help="initial agents per cell; grows before cells fill")
    ap.add_argument("--waypoints", type=int, default=1,
                    help="destination count: W > 1 splits the goal edge "
                         "into W band exits with nearest-exit assignment")
    ap.add_argument("--suite", action="store_true",
                    help="emit three lines: the 1M W=1 headline, a 1M W=8 "
                         "multi-waypoint companion and an 8M scale "
                         "companion; each carries a \"config\" tag and the "
                         "headline comes first")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="measure on a CPU when no GPU is present (tests "
                         "only; the record then says platform cpu)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from pedoni_tpu.utils.cache import enable_compile_cache

    platform = jax.devices()[0].platform
    if platform != "gpu" and not args.allow_cpu:
        print(f"FATAL: bench.py measures a GPU, and JAX's first device is "
              f"{platform!r}; pass --allow-cpu to measure the CPU",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    if args.suite:
        configs = [
            ("headline_1M", {}),
            ("waypoints8_1M", {"waypoints": 8}),
            ("scale_8M", {"agents": 8_000_000}),
        ]
        for tag, over in configs:
            sub = argparse.Namespace(**{**vars(args), "suite": False, **over})
            rec = capture(sub)
            rec["config"] = tag
            print(json.dumps(rec), flush=True)
        return 0
    print(json.dumps(capture(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
