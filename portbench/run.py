"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's inputs from the seed and warms the program on the
cell's own shapes; then a closed loop runs the cell's units for ``--seconds``
(one client: the next unit starts when the last one has finished).  With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` (CPU and CUDA
activities, the program's spans on) and the result holds the per-layer
metrics and a breakdown.  After the window the program's state is freed and
a sample of the window's outputs, drawn from the seed, is held against the
plain references in ``portbench/reference/``.  The last line of standard
output is the result; the numbers compared, each with its limit, are the
last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


#: Host thread pools of the libraries the program computes with, held at
#: one thread: on a machine whose cores other tenants share, a pool of
#: eight waits for its slowest thread (PERF.md gives the runs).
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _program_env(trace: bool) -> None:
    """The program's user defaults, whatever the caller's environment holds;
    one host thread a pool; every cache inside the checkout, at fixed
    paths.  Called before numpy or torch is imported."""
    for key in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[key]
    for key in THREAD_VARS:
        os.environ[key] = "1"
    os.environ["REPRO_TRACE"] = "1" if trace else "0"
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def main(argv=None, control: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    trace = bool(args.trace)
    _program_env(trace)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

    from portbench import harness, isolation

    bad = isolation.scan_imports(harness.HERE)
    if bad:
        print("portbench: " + "; ".join(bad), file=sys.stderr)
        return 4
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        print(f"portbench: no {bench_file}", file=sys.stderr)
        return 2
    cell = harness.load_cell(json.loads(bench_file.read_text()), args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line = harness.execute(cell, args.seed, args.seconds, trace, dev, T_START,
                           control=control)
    # what the program loaded in this process, window and check included
    found = isolation.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    line["device"]["power_limit"] = _power_limit()
    checks = [(n, c["value"], c["limit"]) for n, c in line["checks"].items()]
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
