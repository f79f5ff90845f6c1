"""CLI: ``python -m repro_torch.obs report [paths...]`` — summarize trace logs.

``report`` reads trace JSONL files (default ``{REPRO_TRACE_OUT}/*.jsonl``)
and prints a per-span-name table: count, total/mean/max wall seconds, and
peak RSS watermark.  Pure stdlib, like the lint CLI — it runs anywhere, and
prints the reference's table (``python -m repro.obs report``) for the same
JSONL.

``python -m repro_torch.obs smoke [--device cpu|cuda]`` traces the
reference's toy MW solve end to end on the port (default device ``cuda``),
asserts the traced result is bit-identical to an untraced one, and writes +
schema-validates the Chrome-trace artifact.  Only this sub-command imports
torch and numpy.

Exit status 0 on success, 1 on any problem (2 on a usage error).
"""

from __future__ import annotations

import argparse
import glob
import json
import pathlib
import sys

from . import trace as _trace


def _iter_records(paths: list[str]):
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)


def report(argv: list[str]) -> int:
    requested = argv or [str(pathlib.Path(_trace.TRACE_OUT) / "*.jsonl")]
    # each argument may be a literal path or a glob; missing files are an
    # error, not a crash
    paths = []
    for req in requested:
        paths.extend(sorted(glob.glob(req)) or
                     ([req] if pathlib.Path(req).exists() else []))
    if not paths:
        print(f"no trace JSONL found for {' '.join(requested)} "
              "(run with REPRO_TRACE=1 first)", file=sys.stderr)
        return 1
    # name -> [count, total_s, max_s, max_rss_mb]
    agg: dict[str, list[float]] = {}
    n_events = 0
    for rec in _iter_records(paths):
        if rec.get("kind") != "span":
            n_events += 1
            continue
        row = agg.setdefault(rec["name"], [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += rec["wall_s"]
        row[2] = max(row[2], rec["wall_s"])
        row[3] = max(row[3], rec.get("rss_mb", 0.0))
    if not agg and not n_events:
        print("no records found", file=sys.stderr)
        return 1
    width = max([len(n) for n in agg] + [4])
    print(f"{'span':<{width}}  {'count':>6}  {'total_s':>9}  "
          f"{'mean_s':>9}  {'max_s':>9}  {'rss_mb':>8}")
    for name in sorted(agg, key=lambda n: -agg[n][1]):
        count, total, mx, rss = agg[name]
        print(f"{name:<{width}}  {int(count):>6}  {total:>9.4f}  "
              f"{total / count:>9.4f}  {mx:>9.4f}  {rss:>8.1f}")
    if n_events:
        print(f"(+ {n_events} instant/counter events)")
    return 0


def smoke(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs smoke")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    import numpy as np

    from ..core import (
        build_path_system,
        jellyfish,
        mw_concurrent_flow,
        random_permutation_traffic,
    )
    from ..device import resolve

    dev = resolve(args.device)
    top = jellyfish(n_switches=12, k_ports=5, r_net=4, seed=0)
    comm = random_permutation_traffic(top, seed=0)
    ps = build_path_system(top, comm, k=4, device=dev)

    prev = _trace.set_trace(False)
    try:
        base = mw_concurrent_flow(ps, iters=40, device=dev)

        _trace.set_trace(True)
        _trace.reset_trace()
        with _trace.span("obs_smoke/solve"):
            traced = mw_concurrent_flow(ps, iters=40, device=dev)
    finally:
        _trace.set_trace(prev)

    problems: list[str] = []
    if base.alpha != traced.alpha:
        problems.append("traced alpha differs from untraced")
    if not np.array_equal(np.asarray(base.rates), np.asarray(traced.rates)):
        problems.append("traced rates differ from untraced")

    spans = _trace.get_spans()
    if not any(sp.name == "obs_smoke/solve" for sp in spans):
        problems.append("no obs_smoke/solve span recorded")

    jsonl = _trace.write_jsonl()
    chrome = _trace.write_chrome_trace()
    payload = json.loads(chrome.read_text())
    problems += _trace.validate_chrome_trace(payload)
    if not payload["traceEvents"]:
        problems.append("Chrome trace has no events")

    for p in problems:
        print(f"obs-smoke: {p}", file=sys.stderr)
    if problems:
        return 1
    print(f"obs-smoke OK ({dev}): {len(spans)} span(s), "
          f"{len(payload['traceEvents'])} Chrome event(s) -> {jsonl}, "
          f"{chrome}")
    return 0


def main(argv: list[str]) -> int:
    if argv and argv[0] == "report":
        return report(argv[1:])
    if argv and argv[0] == "smoke":
        return smoke(argv[1:])
    print("usage: python -m repro_torch.obs "
          "{report [paths...] | smoke [--device cpu|cuda]}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
