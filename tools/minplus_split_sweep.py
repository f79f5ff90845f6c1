#!/usr/bin/env python3
"""Time both min-plus kernels at 720^3 over a range of K splits, on one GPU.

    python3 tools/minplus_split_sweep.py

The input is the first APSP squaring of the Fig 1c probe's topology (720
switches of 24 ports, 4320 servers, seed 0), in float32 (+inf) and in the
canonical int16 form.  Each split count is launched straight through the C
entry points of ``csrc/minplus.cu`` (bypassing ``minplus.launch_plan``),
checked equal to the plain version, and timed from the profiler's device
time of the product and the reduction.  This is what ``launch_plan``'s rule
(the fewest K chunks on the busiest SM) was chosen against.  Prints one
JSON line per form, then the card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Split counts asked for; each becomes ceil(chunks / ceil(chunks / want)).
WANTED_SPLITS = (1, 3, 6, 7, 8, 12, 15, 23)
REPS = 50


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    from repro_torch import capacity
    from repro_torch.kernels import _build
    from repro_torch.kernels import minplus as mp

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    top = capacity.jellyfish_same_equipment(720, 24, 4320, seed=0)
    a = torch.from_numpy(top.adjacency()).to(dev)
    d = torch.where(a > 0, 1.0, float("inf")).to(torch.float32)
    d.fill_diagonal_(0.0)
    h = torch.where(torch.isfinite(d), d, float(mp.INT16_INF)).to(torch.int16)
    lib = _build.library("minplus", mp._SIGS)
    stream = torch.cuda.current_stream().cuda_stream

    def device_ms(fn, name):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(ev.device_time_total / ev.count / 1e3
                   for ev in prof.key_averages()
                   if name in ev.key and ev.count) or None

    for form, x, plain, fn, kernel in (
            ("f32", d, mp.minplus_ref, lib.minplus_f32_launch,
             "minplus_f32_kernel"),
            ("hops", h, mp.minplus_hops_ref, lib.minplus_hops_launch,
             "minplus_hops_kernel")):
        m = x.shape[0]
        hops = form == "hops"
        chunks = -(-m // mp.K_STEP)
        out = torch.empty_like(x)
        width = mp.copy_width(x, x, out) if hops else mp.copy_width(x, out)
        want = plain(x, x)
        rows = []
        for asked in WANTED_SPLITS:
            per = -(-chunks // asked)
            splits = -(-chunks // per)
            scratch = torch.empty((splits, m, m), dtype=x.dtype, device=dev)

            def run():
                _build.check_launch(fn(
                    x.data_ptr(), x.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), m, m, m, per * mp.K_STEP, splits,
                    width, stream), "min-plus split sweep")

            run()
            if not torch.equal(out, want):
                sys.exit(f"{form} min-plus at {splits} K splits differs "
                         "from plain")
            tm, tn = mp.HOPS_TILE if hops else mp.F32_TILE
            tiles = -(-m // tm) * -(-m // tn)
            product = device_ms(run, kernel)
            reduction = (device_ms(run, "minplus_reduce_kernel")
                         if splits > 1 else 0.0)
            rows.append({"splits": splits, "blocks": tiles * splits,
                         "product_ms": product, "reduction_ms": reduction,
                         "ms": None if product is None or reduction is None
                         else product + reduction})
        plan = mp.launch_plan(m, m, m, n_sm, hops=hops)
        print(json.dumps({"form": form, "shape": [m, m, m], "n_sm": n_sm,
                          "plan_splits": plan["splits"], "sweep": rows}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
