#!/usr/bin/env python
"""Phase split of the simulation step from one profiler trace.

Runs bench.py's problem (1M agents by default) through ``Simulator.run``,
traces a few steady steps with ``jax.profiler``, and sums the device time
of every operation under each ``jax.named_scope`` of the step (spawn,
sample, sort, local_forces, scatter, pair, gather, integrate; the rest is
"other").  Also prints the device's idle share of the traced window:
1 - (union of device op intervals) / (first op start .. last op end).

    python scripts/profile_step.py [--agents 1000000] [--steps 10] [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

SCOPES = ("spawn", "sample", "sort", "local_forces", "scatter", "pair",
          "gather", "integrate")


def op_scopes(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> step scope, from the op_name metadata the
    named scopes leave in the compiled module."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = .*?metadata=\{[^}]*op_name=\"([^\"]*)\"",
                         hlo_text):
        name, op_name = m.groups()
        parts = op_name.split("/")
        scope = next((p for p in parts if p in SCOPES), "other")
        # kernel events spell "fusion.2" as "fusion_2"
        out[name] = out[name.replace(".", "_")] = scope
    return out


def reduce_trace(xplane: pathlib.Path, scopes: dict[str, str]):
    """(device ns per scope, busy ns, window ns, event count) of the
    device planes of one xplane file (all planes on the CPU backend)."""
    import jax

    pd = jax.profiler.ProfileData.from_file(str(xplane))
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:  # the CPU backend runs its ops on host threads
        planes = list(pd.planes)
    per = collections.Counter()
    spans = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                if op == "command_buffer":
                    # kernels replayed from a CUDA graph carry their fusion
                    # name as the event name
                    op = ev.name
                per[scopes.get(str(op), "other")] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy = 0.0
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return per, busy, window, len(spans)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=10, help="traced steps")
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/profile",
                    help="trace directory")
    args = ap.parse_args()

    import jax

    from bench import card_info, make_bench_simulator
    from pedoni_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    sim = make_bench_simulator(args.agents, 2.5, seed=0)
    sim.run(args.warmup)
    jax.block_until_ready(sim.state)
    hlo = sim._step.lower(sim.state, sim._field_rows,
                          sim._obstacles).compile().as_text()
    scopes = op_scopes(hlo)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "step.hlo.txt").write_text(hlo)

    t0 = time.perf_counter()
    with jax.profiler.trace(str(out)):
        sim.run(args.steps, guard_every=0)
        jax.block_until_ready(sim.state)
    wall = time.perf_counter() - t0
    xplane = max(out.glob("plugins/profile/*/*.xplane.pb"),
                 key=lambda p: p.stat().st_mtime)
    per, busy, window, n_ev = reduce_trace(xplane, scopes)
    total = sum(per.values())
    dev = jax.devices()[0]
    print(f"# {dev.platform} {dev.device_kind} [{card_info()}], "
          f"{args.agents} agents, K={sim.cfg.table_capacity}, "
          f"{args.steps} traced steps, {n_ev} device ops, host wall "
          f"{wall * 1e3:.3f} ms (profiler on)")
    for name in SCOPES + ("other",):
        ns = per.get(name, 0)
        print(f"{name:13s} {ns / args.steps / 1e6:10.4f} ms/step  "
              f"{100 * ns / max(total, 1):6.2f}%")
    print(f"device busy   {busy / args.steps / 1e6:10.4f} ms/step, window "
          f"{window / args.steps / 1e6:.4f} ms/step, idle share "
          f"{1 - busy / max(window, 1):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
