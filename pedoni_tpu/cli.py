"""Command-line interface.

Mirrors the reference CLI (pedoni/src/args.rs:12-44) flag for flag, plus
extras the reference lacks (seed, capacity, devices, checkpoints).  Headless mode reproduces
pedoni/src/main.rs:106-136: run the simulation, log every 100 steps, and on
SIGINT or --max-steps write the JSON diagnostic log to
``logs/<timestamp>_log.json``.

Usage:
    python -m pedoni_tpu [scenario.toml] -H --max-steps 1000
"""

from __future__ import annotations

import argparse
import datetime
import logging
import signal
import time
from pathlib import Path

from .physics import Physics
from .scenario import load_scenario
from .sim import Simulator, SimulatorOptions
from .utils.cache import enable_compile_cache

log = logging.getLogger("pedoni_tpu")

DEFAULT_SCENARIO = Path(__file__).resolve().parents[1] / "scenarios" / "default.toml"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pedoni-tpu", description="social-force crowd simulator on JAX"
    )
    p.add_argument("scenario", nargs="?", default=str(DEFAULT_SCENARIO),
                   help="path to scenario TOML (args.rs:14)")
    p.add_argument("-H", "--headless", action="store_true",
                   help="run headless (args.rs:17)")
    p.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="compute device (args.rs:20-21); auto = JAX's "
                        "default, gpu fails when no GPU is visible")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the simulation over N devices (strips along "
                        "x; the scaling axis the reference lacks)")
    p.add_argument("-s", "--speed", type=float, default=100.0,
                   help="max playback speed multiple of real time (args.rs:23-24)")
    p.add_argument("--no-neighbor-grid", action="store_true",
                   help="disable the neighbor-search grid (args.rs:27-28)")
    p.add_argument("--no-distance-map", action="store_true",
                   help="use exact per-segment obstacle forces (args.rs:30-31)")
    p.add_argument("--field-unit", type=float, default=0.25,
                   help="field grid cell size in meters (args.rs:33-34)")
    p.add_argument("--neighbor-unit", type=float, default=1.4,
                   help="neighbor grid cell size in meters (args.rs:36-37)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps, headless only (args.rs:42-43)")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed (new)")
    p.add_argument("--capacity", type=int, default=0,
                   help="agent capacity; 0 = auto (new)")
    p.add_argument("--table-capacity", type=int, default=16,
                   help="initial agents per neighbor cell; grows before a "
                        "cell fills (new)")
    p.add_argument("--log-dir", default="logs", help="diagnostic log directory")
    p.add_argument("--render", action="store_true",
                   help="live terminal rendering while running")
    p.add_argument("--render-web", type=int, nargs="?", const=8000,
                   default=None, metavar="PORT",
                   help="serve a browser live view on PORT (default 8000): "
                        "drag-pan, scroll-zoom, Space pause — the windowed "
                        "GUI equivalent (renderer/mod.rs:54-63,121-168)")
    p.add_argument("--render-web-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --render-web; use 0.0.0.0 to "
                        "expose the (unauthenticated) viewer beyond this "
                        "machine")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every N steps (new)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file (new)")
    p.add_argument("--record-every", type=int, default=0, metavar="N",
                   help="dump agent positions to <log-dir>/traj_<step>.npz "
                        "every N steps (trajectory analysis)")
    p.add_argument("--frame-every", type=int, default=0, metavar="N",
                   help="render a PNG frame every N steps into <log-dir>")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR "
                        "(the reference measured kernel time and discarded "
                        "it, sfm_gpu.rs:236; we keep it)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def select_device(backend: str) -> None:
    """Pin JAX's default device to ``backend`` (cpu/gpu); ``auto`` keeps
    JAX's own choice.  A platform JAX cannot see is an error, never a
    silent fallback to another device."""
    if backend == "auto":
        return
    import jax

    try:
        devices = jax.devices(backend)
    except RuntimeError as e:
        raise SystemExit(
            f"-b {backend}: JAX sees no {backend} device ({e})") from e
    # Process-wide default device via the config system — unlike a bare
    # context-manager __enter__, this nests cleanly when a library
    # consumer builds several simulators in one process.
    jax.config.update("jax_default_device", devices[0])


def make_simulator(args: argparse.Namespace):
    select_device(args.backend)
    scenario = load_scenario(args.scenario)
    options = SimulatorOptions(
        neighbor_grid_unit=args.neighbor_unit,
        field_grid_unit=args.field_unit,
        use_neighbor_grid=not args.no_neighbor_grid,
        use_distance_map=not args.no_distance_map,
        table_capacity=args.table_capacity,
        capacity=args.capacity,
        seed=args.seed,
        physics=Physics(),
        n_devices=args.devices,
    )
    return Simulator(options, scenario), scenario


def run_headless(args: argparse.Namespace) -> Path:
    sim, _ = make_simulator(args)
    if args.resume:
        from .checkpoint import restore

        restore(sim, args.resume)
        log.info("resumed from %s at step %d", args.resume, sim.step_count)
    diag = sim.new_log(scenario_name=str(args.scenario))

    interrupted = []
    signal.signal(signal.SIGINT, lambda *a: interrupted.append(True))

    renderer = None
    keys = None
    stream = None
    viewer = None
    if getattr(args, "render_web", None) is not None:
        from .webview import WebViewer

        viewer = WebViewer(sim.scenario, fetch=sim.list_pedestrians,
                           port=args.render_web,
                           host=getattr(args, "render_web_host",
                                        "127.0.0.1")).start()
        log.info("web view: %s", viewer.url)
        print(f"web view: {viewer.url}", flush=True)
    if args.render:
        from .renderer import KeyPoller, SnapshotStream, TerminalRenderer

        renderer = TerminalRenderer(sim.scenario)
        keys = KeyPoller()  # SPACE toggles pause (renderer/mod.rs:121-136)
        # Render on a separate thread from the sim loop (the reference's
        # sim-thread / render-thread split, main.rs:20-26, 94-96): the
        # device pipeline is never stalled by a frame fetch.
        stream = SnapshotStream(
            fetch=sim.list_pedestrians,
            on_frame=lambda pos, dest: renderer.draw(pos, dest,
                                                     sim.step_count),
        ).start()

    dt = sim.options.physics.delta_time
    min_interval = dt / args.speed if args.speed > 0 else 0.0

    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)

    paused = False
    try:
        _headless_loop(args, sim, diag, interrupted, renderer, keys,
                       min_interval, paused, viewer)
    finally:
        if viewer is not None:
            viewer.stop()
        if stream is not None:
            stream.stop()
        if keys is not None:
            keys.restore()  # never leave the tty in cbreak/no-echo
        if hasattr(sim, "_traj_writer"):
            sim._traj_writer.close()  # drain the async writer queue

    if args.profile:
        import jax

        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", args.profile)

    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    out = Path(args.log_dir) / f"{ts}_log.json"
    diag.write(out)
    log.info("Exported log file: %s", out)
    return out


def _headless_loop(args, sim, diag, interrupted, renderer, keys,
                   min_interval, paused, viewer=None) -> None:
    while not interrupted:
        start = time.perf_counter()
        if keys is not None:
            for ch in keys.poll():
                if ch == " ":
                    paused = not paused
                elif ch in ("q", "Q"):
                    interrupted.append(True)
                elif renderer is not None:
                    renderer.handle_key(ch)  # camera pan/zoom
        if paused or (viewer is not None and viewer.paused):
            time.sleep(0.05)
            continue
        rec = sim.tick()
        if args.profile and sim.step_count % 100 == 1:
            # Periodic timed fence: isolate device step time from the
            # metric/host overhead (fills the diagnostic slot the
            # reference measured and discarded, sfm_gpu.rs:229-236).
            rec.time_calc_state_kernel = sim.measure_kernel_time()
            rec.time_spawn = sim.measure_spawn_time()
        diag.push(rec)
        if viewer is not None:
            viewer.set_step(sim.step_count)
        if sim.step_count % 100 == 0:
            log.info("Step: %6d, Active pedestrians: %6d",
                     sim.step_count, rec.active_ped_count)
        if args.record_every and sim.step_count % args.record_every == 0:
            if not hasattr(sim, "_traj_writer"):
                from .native import TrajectoryWriter

                sim._traj_writer = TrajectoryWriter(
                    Path(args.log_dir) / "traj.bin")
            pos, dest = sim.list_pedestrians()
            sim._traj_writer.append(sim.step_count, pos, dest)
        if args.frame_every and sim.step_count % args.frame_every == 0:
            from .renderer import save_frame

            pos, dest = sim.list_pedestrians()
            out_dir = Path(args.log_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            save_frame(sim.scenario, pos, dest,
                       str(out_dir / f"frame_{sim.step_count:08d}.png"))
        if args.checkpoint_every and sim.step_count % args.checkpoint_every == 0:
            from .checkpoint import save

            save(sim, Path(args.checkpoint_dir) / f"step_{sim.step_count:08d}.npz")
        if args.max_steps is not None and diag.total_steps >= args.max_steps:
            break
        elapsed = time.perf_counter() - start
        if elapsed < min_interval:
            time.sleep(min_interval - elapsed)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    if args.headless:
        run_headless(args)
        return 0

    # GUI-less interactive fallback: render in the terminal.
    args.render = True
    args.max_steps = args.max_steps or 100000
    run_headless(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
