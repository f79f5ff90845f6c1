"""Run sets of a cell and read the spread of its metrics.

    python3 portbench/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 \\
        [--trace 1] [--control] [--repeat 2] [--out <file>.jsonl] \\
        [--prior <metric>=<spread> ...]

Each run is its own process (``run.py``, or ``control.py`` with
``--control``), one after another; each result line, exit code and wall
time goes to ``--out``.  The summary gives, per metric and per set (a
repeat of the seed list), the median and the spread (``spread``), every
compared number's largest reading, and the units' spread within a run
against that of the runs' median units.  Per metric over all sets it gives
``bound_by_rule``: five times the widest spread, of these sets and of any
read elsewhere (``--prior``, such as the driver's), held between 1 % and
0.25.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


#: A bound is five times the widest spread, within these limits.
BOUND_FLOOR, BOUND_CAP = 0.01, 0.25


def quartile_spread(values: list) -> float | None:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def spread(values: list) -> float | None:
    """The quartile spread, leaving out the run farthest from the median
    where that narrows it: one far-off run in a set does no harm."""
    whole = quartile_spread(values)
    if whole is None or len(values) < 3:
        return whole
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = quartile_spread(values[:far] + values[far + 1:])
    return whole if rest is None else min(whole, rest)


def bound_by_rule(spreads: list) -> float | None:
    """Five times the widest of ``spreads``, held between ``BOUND_FLOOR``
    and ``BOUND_CAP``; ``None`` where no spread was read."""
    read = [s for s in spreads if s is not None]
    if not read:
        return None
    return min(BOUND_CAP, max(BOUND_FLOOR, 5 * max(read)))


def units_spread(lines: list) -> dict | None:
    """The spread of the units' times within each run (``notes.unit_s``)
    and the spread of the runs' median units between them."""
    runs = [x["notes"]["unit_s"] for x in lines
            if len(x.get("notes", {}).get("unit_s", ())) >= 2]
    if not runs:
        return None
    return {"within": [spread(u) for u in runs],
            "medians": [statistics.median(u) for u in runs],
            "between": spread([statistics.median(u) for u in runs])}


def parse_prior(items: list) -> dict:
    """``["sim_step_rate=0.122", ...]`` as ``{metric: [spreads]}``."""
    out = {}
    for item in items:
        name, _, value = item.partition("=")
        out.setdefault(name, []).append(float(value))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--prior", nargs="*", default=[], metavar="METRIC=SPREAD",
                    help="a metric's spread read elsewhere, as a share, that "
                         "its bound_by_rule takes in")
    args = ap.parse_args(argv)
    prior = parse_prior(args.prior)
    script = HERE / ("control.py" if args.control else "run.py")
    out = open(args.out, "a") if args.out else None
    sets = []
    for rep in range(args.repeat):
        lines = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(script), "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)],
                capture_output=True, text=True, check=False)
            wall = time.perf_counter() - t0
            last = proc.stdout.strip().splitlines()[-1:] if proc.stdout else []
            try:
                line = json.loads(last[0]) if last else None
            except json.JSONDecodeError:
                line = None
            rec = {"workload": args.workload, "seed": seed, "set": rep,
                   "trace": args.trace, "control": args.control,
                   "rc": proc.returncode, "wall_s": wall, "result": line}
            if line is None:
                rec["stderr_tail"] = proc.stderr[-3000:]
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            brief = {k: v["value"] for k, v in (line or {}).get("metrics", {}).items()}
            print(json.dumps({"seed": seed, "set": rep, "rc": proc.returncode,
                              "wall_s": round(wall, 1),
                              "correct": (line or {}).get("correct"),
                              "metrics": brief,
                              "checks": {k: v["value"] for k, v in
                                         (line or {}).get("checks", {}).items()}}),
                  flush=True)
            if line is None:
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
            lines.append(line)
        sets.append([x for x in lines if x])
    if out:
        out.close()
    spreads = {}
    for rep, lines in enumerate(sets):
        names = sorted({m for x in lines for m in x["metrics"]})
        for m in names:
            vals = [x["metrics"][m]["value"] for x in lines if m in x["metrics"]]
            spreads.setdefault(m, []).append(spread(vals))
            print(json.dumps({"set": rep, "metric": m, "n": len(vals),
                              "median": statistics.median(vals),
                              "spread": spreads[m][-1],
                              "quartile_spread": quartile_spread(vals),
                              "values": vals}))
        checks = sorted({c for x in lines for c in x["checks"]})
        for c in checks:
            vals = [x["checks"][c]["value"] for x in lines]
            print(json.dumps({"set": rep, "check": c, "max": max(vals),
                              "min": min(vals), "values": vals}))
        print(json.dumps({"set": rep, "units": units_spread(lines)}))
    for m, read in sorted(spreads.items()):
        print(json.dumps({"metric": m, "spreads": read,
                          "prior": prior.get(m, []),
                          "bound_by_rule": bound_by_rule(
                              read + prior.get(m, []))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
