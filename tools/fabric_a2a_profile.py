#!/usr/bin/env python3
"""Where the time of the 1024-pod all-to-all score goes, on one GPU.

    python3 tools/fabric_a2a_profile.py [--pods 1024]

Scores all-to-all traffic (``FabricModel.a2a_efficiency``) on a Jellyfish
fabric of degree 8 (seed 0, ``chip_smoke.py``'s ``fabric`` configuration)
twice on the card, each from a cleared routing cache: once plain (its
seconds), then traced and under ``torch.profiler`` (device activity only):
the seconds of the hop matrix, the enumeration and the Python usage loop
(spans ``fabric/a2a/*``), and inside the enumeration the device time and
launches of the two kernels (``minplus_hops``, ``admission``) and of the
host-device copies.  The profiler's own start and stop are timed apart
and left out of the profiled call's seconds.  Prints one JSON line, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    from repro_torch import kernels, obs
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.fabric import make_fabric

    dev = torch.device("cuda")
    fb = make_fabric("jellyfish", n_pods=args.pods, degree=8, seed=0,
                     device=dev)
    out = {"pods": args.pods, "pairs": args.pods * (args.pods - 1)}

    clear_routing_cache()
    with obs.Timer(device=dev) as t:
        plain = fb.a2a_efficiency()
    out.update({"a2a_efficiency": plain, "seconds": t.dt})

    clear_routing_cache()
    kernels.reset_launch_counts()
    prev = obs.set_trace(True)
    obs.reset_trace()
    try:
        with obs.Timer() as whole:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                with obs.Timer(device=dev) as t:
                    traced = fb.a2a_efficiency()
        spans = {}
        for s in obs.get_spans():
            if s.name.startswith(("fabric/a2a/", "build/")):
                spans[s.name] = spans.get(s.name, 0.0) + s.wall_s
    finally:
        obs.set_trace(prev)
        obs.reset_trace()
    if traced != plain:
        sys.exit(f"the traced score {traced} differs from the plain {plain}")
    device = {}
    for ev in prof.key_averages():
        for name in ("minplus_hops", "admission", "Memcpy"):
            if name in ev.key and ev.device_time_total > 0:
                row = device.setdefault(name, {"ms": 0.0, "count": 0})
                row["ms"] += ev.device_time_total / 1e3
                row["count"] += ev.count
    out.update({
        "profiled_seconds": t.dt,
        "profiler_overhead_seconds": whole.dt - t.dt,
        "span_seconds": spans,
        "device_ms": device or "the profiler recorded no device time",
        "launches": kernels.launch_counts(),
    })
    print(json.dumps(out), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
