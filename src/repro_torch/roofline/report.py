"""CLI: render the roofline table from dry-run cells.

The port of ``repro/roofline/report.py``, reading the cells of
``launch.dryrun`` (``op_stats`` where the reference has ``hlo_stats``):

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.roofline.report --cell qwen2.5-32b train_4k pod16x16
"""

from __future__ import annotations

import argparse
import json
import pathlib

__all__ = ["fmt", "main"]


def fmt(v: float) -> str:
    return f"{v:.4f}" if v >= 1e-4 else (f"{v:.2e}" if v > 0 else "0")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--collectives", action="store_true",
                    help="print top collectives per cell")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.dir)

    if args.cell:
        arch, shape, mesh = args.cell
        d = json.loads((root / f"{arch}__{shape}__{mesh}.json").read_text())
        print(json.dumps({k: v for k, v in d.items() if k != "op_stats"},
                         indent=1))
        if args.collectives and "op_stats" in d:
            for c in d["op_stats"]["collectives"][:15]:
                print(f"  {c['kind']:18s} {c['payload_bytes']/1e6:10.2f}MB "
                      f"group={c['group']:4d} count={c['count']:8.1f}")
        return

    print(f"{'arch':18s} {'shape':12s} {'mesh':11s} "
          f"{'compute':>9s} {'memory':>9s} {'collect':>9s} {'dom':6s} "
          f"{'useful':>6s} {'bound':>9s} {'peak_GB':>8s}")
    for p in sorted(root.glob("*.json")):
        d = json.loads(p.read_text())
        if d["status"] == "skipped":
            print(f"{d['arch']:18s} {d['shape']:12s} {d['mesh']:11s} "
                  f"{'(skipped: full attention @500k)':s}")
            continue
        if d["status"] != "ok":
            print(f"{d['arch']:18s} {d['shape']:12s} {d['mesh']:11s} ERROR")
            continue
        r = d["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        shape = d["shape"] + ("+int8" if "grad_compression" in d else "")
        print(f"{d['arch']:18s} {shape:12s} {d['mesh']:11s} "
              f"{fmt(r['compute_s']):>9s} {fmt(r['memory_s']):>9s} "
              f"{fmt(r['collective_s']):>9s} {r['dominant'][:6]:6s} "
              f"{d['useful_flops_ratio']:6.2f} {fmt(bound):>9s} "
              f"{d['memory']['peak_bytes'] / 1e9:8.2f}")


if __name__ == "__main__":
    main()
