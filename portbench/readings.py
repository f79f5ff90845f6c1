"""Read a cell's compared numbers over many seeds in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control | --fault <name>] [--seconds 0] [--trace 0] \\
        [--check-units n] [--backend gather|dense] [--out <file>.jsonl]

Each seed is one run of the cell through the harness (set-up, a window of
``--seconds``, at least one unit, then the check), with the control
(``--control``) or a planted fault (``--fault``, see ``faults.py``) in the
program's place; ``--check-units`` checks more of a run's units than the
traffic file says, ``--backend`` sends the program's congestion product to
one backend in place of its own choice.  One process pays the imports and the card's start once,
so a dozen seeds cost what a few runs of ``run.py`` do.  Each run's result
line goes to ``--out`` and a summary of its compared numbers to standard
output.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--check-units", type=int, default=None)
    ap.add_argument("--backend", choices=("gather", "dense"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from run import _program_env

    _program_env(bool(args.trace))
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                             args.workload)
    if args.check_units:
        cell.traffic["check_units"] = args.check_units
    if args.backend:
        from repro_torch.kernels import ops

        ops.preferred_congestion_backend = lambda *a, **kw: args.backend
    hook = faults.install(args.fault) if args.fault else None
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = harness.execute(cell, seed, args.seconds, bool(args.trace), dev,
                               t0, hook=hook, control=args.control)
        rec = {"workload": cell.name, "seed": seed, "control": args.control,
               "fault": args.fault, "trace": args.trace,
               "wall_s": time.perf_counter() - t0, "result": line}
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "control": args.control,
                          "correct": line["correct"],
                          "checks": {k: v["value"] for k, v in
                                     line["checks"].items()},
                          "wall_s": round(rec["wall_s"], 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
