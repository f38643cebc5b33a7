"""Library quickstart: build a scene in code, simulate, inspect, plot.

Run:  python examples/quickstart.py        (any device JAX supports)

Shows the object-level API (the same surface the CLI drives):
Scenario -> Simulator -> tick()/run() -> list_pedestrians()/metrics,
plus a checkpoint round trip and an optional PNG snapshot.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from pedoni_tpu import Scenario, Segment, Simulator, SimulatorOptions
from pedoni_tpu.scenario import PedestrianGroup, SpawnConfig


def build_scenario() -> Scenario:
    """A 40 x 14 m corridor with a mid-corridor pillar and two opposing
    pedestrian streams (the reference's lanes.toml in miniature)."""
    return Scenario(
        size=(40.0, 14.0),
        waypoints=(
            Segment(line=((1.0, 2.0), (1.0, 12.0)), width=1.0),    # west gate
            Segment(line=((39.0, 2.0), (39.0, 12.0)), width=1.0),  # east gate
        ),
        obstacles=(
            Segment(line=((20.0, 6.0), (20.0, 8.0)), width=2.0),   # pillar
        ),
        pedestrians=(
            PedestrianGroup(origin=0, destination=1,
                            spawn=SpawnConfig(kind="periodic", frequency=3.0)),
            PedestrianGroup(origin=1, destination=0,
                            spawn=SpawnConfig(kind="periodic", frequency=3.0)),
            PedestrianGroup(origin=0, destination=1,
                            spawn=SpawnConfig(kind="once", count=40)),
        ),
    )


def main() -> None:
    scenario = build_scenario()
    # SimulatorOptions mirrors the reference's flags; n_devices>1 shards
    # the field spatially over a device mesh.
    sim = Simulator(SimulatorOptions(seed=42), scenario)

    for step in range(200):
        rec = sim.tick()
        if step % 50 == 0:
            print(f"step {step:4d}: {rec.active_ped_count:4d} active, "
                  f"{rec.time_calc_state * 1000:6.2f} ms/step")

    pos, dest = sim.list_pedestrians()
    print(f"final: {len(pos)} agents; "
          f"x span [{pos[:, 0].min():.1f}, {pos[:, 0].max():.1f}] m")

    # checkpoint round trip (restores across device counts)
    from pedoni_tpu.checkpoint import restore, save

    save(sim, "/tmp/quickstart_ck.npz")
    sim2 = Simulator(SimulatorOptions(seed=0), scenario)
    restore(sim2, "/tmp/quickstart_ck.npz")
    assert sim2.pedestrian_count == sim.pedestrian_count
    print(f"checkpoint restored at step {sim2.step_count}")

    try:  # optional PNG snapshot (matplotlib)
        from pedoni_tpu.renderer import save_frame

        save_frame(scenario, pos, dest, "/tmp/quickstart.png")
        print("wrote /tmp/quickstart.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
