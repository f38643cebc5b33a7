#!/usr/bin/env python
"""Proof that the simulator runs on an NVIDIA GPU through the entry points
users call.

    python chip_smoke.py              # one card: phases 1-4, then the result
    python chip_smoke.py --devices 4  # the sharded path on four cards only

One card, phases in order, each printing one line of findings; any failure
ends the run with a non-zero exit and no result line:

1. device    JAX's first device is a GPU; the card's name and power limit
             as nvidia-smi gives them; the native FMM library builds.
2. scenario  scenarios/gap.toml through the CLI with ``-b gpu`` evacuates
             within 300 steps and writes its JSON log.
3. headline  bench.py's 1M-agent problem through ``Simulator.run``:
             ms/step, agent-steps/s, the step's memory analysis, peak bytes,
             cell overflow and peak cell demand.
4. oracle    a crop of 1,000 agents at the bench density, 50 steps,
             against the independent f64 oracle (tests/oracle_sfm.py):
             the same agents left, 95% within 5e-3 m, median <= 1e-4 m.
   cpu       one step of the 1M headline state on the GPU and on the CPU,
             same jitted step: equal active counts, <= 1e-4 m.

``--devices N`` runs only the sharded phase: bench.py's problem at N x 1M
agents through ``Simulator(n_devices=N)`` against the one-card step from the
same state (equal counts every step, positions within 1e-4 m after 3
steps), checkpoints restored across the two device counts both ways, and
the sharded step timed.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DENSITY = 2.5  # bench.py's default crowd density, agents per m^2
# f32 step vs f64 oracle over 50 interacting steps.  The reference's FOV
# rule halves a pair force on one side of a threshold, so a pair within f32
# rounding of it takes the other branch in one of the two runs (~1e-3 m in
# one step) and chaos spreads that to its neighbours: at 1,000 agents the
# largest error is not bounded by rounding, and the check reads the bulk.
ORACLE_TOL = 5e-3  # 95th percentile of per-agent |dpos|
ORACLE_MEDIAN_TOL = 1e-4  # median: f32 drift alone (measured ~4e-6)
CROSS_TOL = 1e-4  # same arithmetic, another summation order


class SmokeError(RuntimeError):
    """A phase found the system wrong."""


def require_gpus(n: int) -> list:
    """The process's GPUs; fails unless JAX's first device is a GPU and
    there are at least ``n``."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"JAX finds no GPU (first device: {devs[0].platform})")
    if len(devs) < n:
        raise SmokeError(f"{n} GPUs asked for, JAX sees {len(devs)}")
    return devs


def result_line(devices) -> str:
    """The last line: what ran, as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def _import_repo():
    """Put the checkout on the path; fails outside a checkout."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import bench  # noqa: F401
    import pedoni_tpu  # noqa: F401


def _memory_line(sim) -> str:
    """Compiled memory analysis of the simulator's step and the peak bytes
    in use on its first device so far."""
    import jax

    compiled = sim._step.lower(sim.state, sim._field_rows,
                               sim._obstacles).compile()
    ma = compiled.memory_analysis()
    parts = []
    if ma is not None:
        parts.append(f"step temp {ma.temp_size_in_bytes} B, args "
                     f"{ma.argument_size_in_bytes} B, out "
                     f"{ma.output_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats()
    if stats:
        parts.append(f"peak_bytes_in_use {stats['peak_bytes_in_use']}")
    return ", ".join(parts) or "memory analysis not available"


def _tagged_problem(n_agents: int, seed: int, n_field: int | None = None):
    """bench.py's problem with every desired speed made unique (1.0 m/s up
    in f32 steps of 2^-23), so agents can be matched across slot orders.
    ``n_field`` sizes the field as bench.py would for that many agents, of
    which the first ``n_agents`` are active."""
    import jax.numpy as jnp
    import numpy as np

    from bench import build_problem

    scenario, state = build_problem(n_field or n_agents, DENSITY, seed)
    if n_field:
        active = np.arange(state.agents.pos.shape[0]) < n_agents
        state = state._replace(agents=state.agents._replace(
            active=jnp.asarray(active)))
    cap = state.agents.pos.shape[0]
    if cap > 2**22:
        raise ValueError("speed tags stay below 1.5 m/s only up to 4M slots")
    tags = (1.0 + np.arange(cap, dtype=np.float64) * 2.0**-23).astype(np.float32)
    state = state._replace(agents=state.agents._replace(speed=jnp.asarray(tags)))
    return scenario, state


def _host_agents(sim):
    """(pos, active, speed tags) of a simulator's state on the host."""
    import numpy as np

    a = sim.state.agents
    return np.asarray(a.pos), np.asarray(a.active), np.asarray(a.speed)


def _tag_diff(ref, other) -> float:
    """Max position difference between two host agent sets matched by
    speed tag; SmokeError if they hold different agents."""
    import numpy as np

    (p0, a0, t0), (p1, a1, t1) = ref, other
    t0, t1 = t0[a0], t1[a1]
    if len(t0) != len(t1):
        raise SmokeError(f"active counts differ: {len(t0)} vs {len(t1)}")
    o0, o1 = np.argsort(t0), np.argsort(t1)
    if not np.array_equal(t0[o0], t1[o1]):
        raise SmokeError("the two runs hold different agents")
    if len(t0) == 0:
        return 0.0
    return float(np.abs(p0[a0][o0] - p1[a1][o1]).max())


def phase_device() -> str:
    import jax

    from bench import card_info
    from pedoni_tpu import native

    d = jax.devices()
    print(f"device: {d[0].platform} {d[0].device_kind} x{len(d)}, "
          f"jax {jax.__version__}", flush=True)
    card = card_info()
    print(f"card: {card}", flush=True)
    if not native.available():
        raise SmokeError("the native FMM library did not build (g++); the "
                         "pure-Python FMM is too slow for the 1M field")
    print("fmm: native (pedoni_tpu/native/libpedoni_native.so, g++)",
          flush=True)
    return card


def phase_scenario(backend: str = "gpu", max_steps: int = 300) -> int:
    """gap.toml through the CLI; returns the step at which it emptied."""
    from pedoni_tpu.cli import main as cli_main

    with tempfile.TemporaryDirectory() as log_dir:
        rc = cli_main([str(ROOT / "scenarios" / "gap.toml"), "-H",
                       "--max-steps", str(max_steps), "-s", "0", "--seed",
                       "1", "-b", backend, "--log-dir", log_dir])
        logs = sorted(pathlib.Path(log_dir).glob("*_log.json"))
        if rc != 0 or not logs:
            raise SmokeError(f"CLI exited {rc} and wrote {len(logs)} logs")
        counts = json.loads(logs[-1].read_text())["step_metrics"][
            "active_ped_count"]
    if 0 not in counts:
        raise SmokeError(f"gap.toml still holds {counts[-1]} agents after "
                         f"{len(counts)} steps")
    step = counts.index(0) + 1
    print(f"scenario: gap.toml via cli -b {backend} evacuated at step "
          f"{step} of {max_steps}, JSON log written", flush=True)
    return step


def phase_headline(card: str, n_agents: int = 1_000_000, warmup: int = 16,
                   windows: int = 5, window: int = 20):
    """bench.py's problem through Simulator.run; returns the simulator."""
    import jax

    from bench import make_bench_simulator, timed_windows

    t0 = time.perf_counter()
    sim = make_bench_simulator(n_agents, DENSITY, seed=0)
    sim.run(warmup)
    jax.block_until_ready(sim.state)
    setup = time.perf_counter() - t0
    times = timed_windows(sim, windows, window)
    m = sim.last_run_metrics
    med = statistics.median(times)
    print(f"headline: {n_agents} agents, {med * 1e3:.4f} ms/step median of "
          f"{windows}x{window} (min {min(times) * 1e3:.4f}, max "
          f"{max(times) * 1e3:.4f}), {int(m.n_active) / med:.6g} "
          f"agent-steps/s, K={sim.cfg.table_capacity}, n_overflow "
          f"{int(m.n_overflow)}, max_demand {int(m.max_demand)}, setup+warmup "
          f"{setup:.1f}s, {_memory_line(sim)} [{card}]", flush=True)
    if int(m.n_active) <= 0:
        raise SmokeError("the headline crowd vanished")
    return sim


def phase_oracle(n_agents: int = 1000, n_steps: int = 50, seed: int = 3,
                 card: str = "") -> float:
    """A crop through the XLA step on the default device against the f64
    oracle; returns the 95th percentile of the per-agent position error
    in metres."""
    import jax
    import numpy as np

    from oracle_sfm import oracle_run, tagged_errors
    from pedoni_tpu.field import Field, FieldMaps
    from pedoni_tpu.models.sfm import StepConfig, device_inputs, make_step

    # bench.py keeps a 2 m margin free of agents; a field 4 m wider than
    # the crowd holds it at the bench's density
    side = (n_agents / DENSITY) ** 0.5 + 4.0
    scenario, state = _tagged_problem(n_agents, seed,
                                      n_field=int(DENSITY * side * side))
    cap = state.agents.pos.shape[0]
    field = Field.from_scenario(scenario, unit=0.25)
    maps = FieldMaps.from_field(field)
    # K well above the crop's densest cell: the oracle's cells are unbounded
    cfg = StepConfig.build(scenario, capacity=cap, table_capacity=32)
    dfield, obstacles = device_inputs(cfg, maps)
    step = jax.jit(make_step(cfg, maps))
    s = state
    overflow = 0
    for _ in range(n_steps):
        s, m = step(s, dfield.rows, obstacles)
        overflow += int(m.n_overflow)
    if overflow:
        raise SmokeError(f"{overflow} cell overflows in the oracle crop")
    a = state.agents
    o_pos, o_act = oracle_run(
        field, np.asarray(a.pos), np.asarray(a.vel), np.asarray(a.speed),
        np.asarray(a.dest), np.asarray(a.active), scenario.size,
        cfg.grid.unit, n_steps)
    b = s.agents
    try:
        errs = tagged_errors(np.asarray(a.speed), o_pos, o_act,
                             np.asarray(b.pos), np.asarray(b.active),
                             np.asarray(b.speed))
    except AssertionError as e:
        raise SmokeError(f"oracle crop: {e}") from e
    if not errs.size:
        raise SmokeError("no agent left in the oracle crop")
    p95, med = float(np.percentile(errs, 95)), float(np.median(errs))
    print(f"oracle: {n_agents} agents at {DENSITY}/m^2 x {n_steps} steps on "
          f"{jax.devices()[0].platform}, {errs.size} left in both, |dpos| vs "
          f"f64 oracle: median {med:.3e} m (limit {ORACLE_MEDIAN_TOL:g}), "
          f"p95 {p95:.3e} m (limit {ORACLE_TOL:g}), max {errs.max():.3e} m, "
          f"{int((errs > ORACLE_TOL).sum())} agents beyond {ORACLE_TOL:g} "
          f"[{card}]", flush=True)
    if not (med <= ORACLE_MEDIAN_TOL and p95 <= ORACLE_TOL):
        raise SmokeError(f"oracle crop off: median {med:.3e} m, p95 "
                         f"{p95:.3e} m")
    return p95


def phase_cpu(sim, card: str = "") -> float:
    """One step of ``sim``'s state through its jitted step on its own
    device and on the CPU; returns the largest position difference."""
    import jax
    import numpy as np

    args = (sim.state, sim._field_rows, sim._obstacles)
    s_dev, m_dev = sim._step(*args)
    s_cpu, m_cpu = sim._step(*jax.device_put(args, jax.devices("cpu")[0]))
    n_dev, n_cpu = int(m_dev.n_active), int(m_cpu.n_active)
    act = np.asarray(s_dev.agents.active)
    if n_dev != n_cpu or not np.array_equal(act, np.asarray(s_cpu.agents.active)):
        raise SmokeError(f"active counts differ: {n_dev} on "
                         f"{jax.devices()[0].platform}, {n_cpu} on cpu")
    d = np.abs(np.asarray(s_dev.agents.pos)[act]
               - np.asarray(s_cpu.agents.pos)[act])
    worst = float(d.max()) if d.size else 0.0
    print(f"cpu: 1 step of the {n_dev}-agent headline state, "
          f"{jax.devices()[0].platform} vs cpu, counts equal, max |dpos| "
          f"{worst:.3e} m (limit {CROSS_TOL:g}) [{card}]", flush=True)
    if not worst <= CROSS_TOL:
        raise SmokeError(f"gpu and cpu steps differ by {worst:.3e} m")
    return worst


def phase_sharded(n_devices: int, agents_per_device: int = 1_000_000,
                  compare_steps: int = 3, warmup: int = 16, windows: int = 5,
                  window: int = 40, card: str = "") -> float:
    """The sharded step against the one-card step from one state, with
    checkpoints restored across both device counts; returns the largest
    position difference after ``compare_steps``."""
    import jax
    import numpy as np

    from bench import timed_windows
    from pedoni_tpu import Simulator, SimulatorOptions
    from pedoni_tpu.checkpoint import restore, save

    n_agents = n_devices * agents_per_device
    scenario, init = _tagged_problem(n_agents, seed=0)
    cap = init.agents.pos.shape[0]
    # K=24 keeps every cell below K (bench density: 4.9 agents per cell on
    # average), so no run loses pair forces to a slot order the other lacks
    opts = SimulatorOptions(capacity=cap, table_capacity=24)

    def run(sim):
        counts = []
        for _ in range(compare_steps):
            rec = sim.tick()
            if int(sim.last_metrics.n_overflow):
                raise SmokeError("a cell overflowed during the comparison")
            if int(sim.last_metrics.n_deferred):
                raise SmokeError("exchange packages saturated during the "
                                 "comparison")
            counts.append(rec.active_ped_count)
        return counts

    t0 = time.perf_counter()
    sim_d = Simulator(dataclasses.replace(opts, n_devices=n_devices), scenario)
    sim_d.set_state(init)
    setup = time.perf_counter() - t0
    counts_d = run(sim_d)
    after_d = _host_agents(sim_d)

    sim_d.run(warmup)
    jax.block_until_ready(sim_d.state)
    times = timed_windows(sim_d, windows, window)
    m = sim_d.last_run_metrics
    med = statistics.median(times)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", "n/a")
             for d in jax.devices()[:n_devices]]
    print(f"sharded: {n_agents} agents on {n_devices} devices, "
          f"{med * 1e3:.4f} ms/step median of {windows}x{window} (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{int(m.n_active) / med:.6g} agent-steps/s, n_deferred "
          f"{int(m.n_deferred)}, n_overflow {int(m.n_overflow)}, "
          f"peak_bytes_in_use per device {peaks}, setup {setup:.1f}s "
          f"[{card}]", flush=True)

    sim_1 = Simulator(opts, scenario)
    sim_1.set_state(init)
    counts_1 = run(sim_1)
    worst = _tag_diff(_host_agents(sim_1), after_d)
    peak_1 = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "n/a")
    print(f"compare: {n_devices} devices vs 1, active counts per step "
          f"{counts_d} vs {counts_1}, max |dpos| after {compare_steps} "
          f"steps {worst:.3e} m (limit {CROSS_TOL:g}), one-card "
          f"peak_bytes_in_use {peak_1} [{card}]", flush=True)
    if counts_d != counts_1:
        raise SmokeError("active counts differ between device counts")
    if not worst <= CROSS_TOL:
        raise SmokeError(f"sharded and one-card runs differ by {worst:.3e} m")

    with tempfile.TemporaryDirectory() as td:
        ck_d, ck_1 = pathlib.Path(td) / "d.npz", pathlib.Path(td) / "1.npz"
        save(sim_d, ck_d)
        save(sim_1, ck_1)
        held_d, held_1 = _host_agents(sim_d), _host_agents(sim_1)
        restore(sim_1, ck_d)
        restore(sim_d, ck_1)
    if _tag_diff(held_d, _host_agents(sim_1)) != 0.0:
        raise SmokeError(f"{n_devices}-device checkpoint restored on one "
                         "device changed positions")
    if _tag_diff(held_1, _host_agents(sim_d)) != 0.0:
        raise SmokeError(f"one-device checkpoint restored on {n_devices} "
                         "devices changed positions")
    n_1, n_d = sim_1.tick().active_ped_count, sim_d.tick().active_ped_count
    print(f"checkpoint: {n_devices} devices -> 1 and 1 -> {n_devices} "
          f"restored exactly ({int(held_d[1].sum())} and "
          f"{int(held_1[1].sum())} agents); next step {n_1} and {n_d} "
          "active", flush=True)
    if not (np.isfinite(held_d[0]).all() and n_1 > 0 and n_d > 0):
        raise SmokeError("restored runs did not continue")
    return worst


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="run only the sharded phase on N cards")
    args = ap.parse_args(argv)
    try:
        devices = require_gpus(args.devices)
        _import_repo()
        from pedoni_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()
        card = phase_device()
        if args.devices > 1:
            phase_sharded(args.devices, card=card)
            devices = devices[:args.devices]
        else:
            phase_scenario()
            sim = phase_headline(card)
            phase_oracle(card=card)
            phase_cpu(sim, card=card)
            devices = devices[:1]
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
