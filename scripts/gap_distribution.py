#!/usr/bin/env python
"""Evacuation-time distribution on gap.toml across seeds — the reference
author's own fidelity harness (pedoni/src/main.rs:58-77).

    python scripts/gap_distribution.py [--seeds 5] [--devices N]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from pedoni_tpu import Simulator, SimulatorOptions, load_scenario  # noqa: E402

GAP = pathlib.Path(__file__).resolve().parents[1] / "scenarios" / "gap.toml"


def evac_steps(seed: int, n_devices: int = 1, max_steps: int = 600) -> int:
    sim = Simulator(SimulatorOptions(seed=seed, n_devices=n_devices),
                    load_scenario(GAP))
    for i in range(1, max_steps + 1):
        if sim.tick().active_ped_count == 0:
            return i
    return -1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--devices", type=int, default=1)
    args = ap.parse_args()
    import numpy as np

    steps = [evac_steps(s, args.devices) for s in range(1, args.seeds + 1)]
    print(f"{args.devices} device(s): {steps}  mean {np.mean(steps):.0f} "
          f"± {np.std(steps):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
