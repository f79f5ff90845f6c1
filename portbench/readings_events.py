"""Read the event cell's compared numbers over many seeds in one process.

    python3 portbench/readings_events.py --workload rrg512x8.sim_events \\
        --seeds 1 2 3 [--control | --fault <name>] [--fail-fraction F] \\
        [--out <file>.jsonl]

``readings.py`` with the event path's planted faults (``faults_events.py``)
added to those it knows; every other option is ``readings.py``'s.
``--fail-fraction`` sets the share of links each ``fail_links`` event of
the traffic removes: at the cell's 5 % no switch is cut off and no flow is
killed, so ``events.kill_unaccounted`` is read at the full width with a
fraction that kills (0.9).  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import faults, faults_events, harness, readings

    faults.FAULTS.update(faults_events.FAULTS)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fail-fraction", type=float, default=None)
    args, rest = ap.parse_known_args()
    if args.fail_fraction is not None:
        plain = harness.load_cell

        def load_cell(*a, **kw):
            cell = plain(*a, **kw)
            for ev in cell.traffic["events"]:
                if ev["kind"] == "fail_links":
                    ev["fraction"] = args.fail_fraction
            return cell

        harness.load_cell = load_cell
    sys.exit(readings.main(rest))
