"""The two readings each correctness limit is set from, on the card.

    python perfbench/tools/readings.py --workload <name> --seeds 101 102 ... [--views N]

For each seed, in one process: the cell's set-up, ``--views`` views through
the timed path (default: one pass over the distinct targets or items), then
the program's numbers against the reference and the control's (the
reference one precision step down, put in the program's place) against
it. Prints one JSON line per seed, then the largest program reading and
the smallest control reading of each number. ``--fault`` breaks the timed
path instead (``alter_answer``: one view's static layer and composite
offset by 0.05; ``half_sources``: half of the spatial sources left out)
and reads what the fault gives.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def readings(cell, seeds, fault=None, device="cuda", overrides=None, views=0):
    """[{seed, views, program, control, seconds}] for each seed."""
    sys.path.insert(0, str(ROOT))
    from perfbench.drivers import driver
    from perfbench.harness.bench import Ctx, load_json

    bench = load_json(ROOT / "BENCHMARK.json")
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = Ctx(bench, cell, seed, device, t0, overrides)
        drv = driver(ctx.traffic["driver"])(ctx, fault=fault)
        drv.setup()
        for i in range(views or drv.n_distinct()):
            drv.view(i)
        ctx.sync()
        drv.release()
        out = drv.check(control=fault is None)
        rows.append({"seed": seed, "views": out["views"], "program": out["worst"],
                     "control": out.get("control"), "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--views", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default=None, help="JSON of config / traffic overrides")
    args = ap.parse_args(argv)
    over = json.loads(args.overrides) if args.overrides else None
    lows, highs = {}, {}
    for seed in args.seeds:
        row = readings(args.workload, [seed], args.fault, args.device, over, args.views)[0]
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in (row["control"] or {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps({"program_max": lows, "control_min": highs}), flush=True)


if __name__ == "__main__":
    main()
