"""Run sets of a cell and read the spread of its metrics.

    python3 portbench/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 \\
        [--trace 1] [--control] [--repeat 2] [--out <file>.jsonl]

Each run is its own process (``run.py``, or ``control.py`` with
``--control``), one after another; each result line, exit code and wall
time goes to ``--out``.  The summary gives, per metric and per set (a
repeat of the seed list), the median and the quartile spread as a share of
the median (``statistics.quantiles(values, n=4)``), and every compared
number's largest reading.
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


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
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
    for rep, lines in enumerate(sets):
        names = sorted({m for x in lines for m in x["metrics"]})
        for m in names:
            vals = [x["metrics"][m]["value"] for x in lines if m in x["metrics"]]
            print(json.dumps({"set": rep, "metric": m, "n": len(vals),
                              "median": statistics.median(vals),
                              "spread": spread(vals), "values": vals}))
        checks = sorted({c for x in lines for c in x["checks"]})
        for c in checks:
            vals = [x["checks"][c]["value"] for x in lines]
            print(json.dumps({"set": rep, "check": c, "max": max(vals),
                              "min": min(vals), "values": vals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
