"""Elastic scaling demo on the PyTorch port: the paper's incremental
expansion as a *runtime* feature.  A training cluster's inter-pod fabric is
a Jellyfish; we grow it, fail parts of it, re-embed the collective ring each
time, and re-plan the device mesh — checkpoint-restore included.

The counterpart of ``examples/expand_cluster.py`` through ``repro_torch``.
Routing rides the delta engine: each mutation carries its edge delta, so
the fabric's path system is *updated* (``routing.update_path_system`` via
``FabricModel.path_system``) rather than rebuilt, and the MW flow solver
warm-starts from the pre-mutation rates.  APSP, the admission prunes and
the MW solves run on ``--device`` (the kernels on a card).

    PYTHONPATH=src python examples/expand_cluster_torch.py
    PYTHONPATH=src python examples/expand_cluster_torch.py --device cpu

``main()`` returns the readings it prints (descriptions, path counts,
alphas, spliced shares, ring and mesh re-plans), a digest of each path
system, and each MW solve's path system, warm start and result
(``"solves"``).
"""

import argparse
import hashlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import (
    extend_server_permutation,
    mw_concurrent_flow,
    permutation_commodities,
    random_server_permutation,
)
from repro_torch.device import resolve
from repro_torch.fabric import make_fabric
from repro_torch.runtime.elastic import plan_mesh, replan


def _spliced(ps) -> float:
    return float((ps.row_map >= 0).mean()) if ps.row_map is not None else 0.0


def system_digest(ps) -> str:
    """A digest of a path system's tables (rows, lengths, owners, demands,
    capacities, row map): equal digests, equal path systems."""
    h = hashlib.sha1()
    for a in (ps.path_edges, ps.path_len, ps.path_owner, ps.row_map):
        h.update(b"-" if a is None else np.asarray(a, np.int64).tobytes())
    for a in (ps.demands, ps.capacities):
        h.update(np.asarray(a, np.float64).tobytes())
    return h.hexdigest()[:16]


def run(dev, ckpt_dir: str) -> dict:
    out = {"routing": [], "solves": []}

    def _route(fabric, comm, warm=None) -> tuple:
        """Route ``comm`` over ``fabric`` and solve MW warm from ``warm``;
        record the reading and the solve's inputs and result."""
        t0 = time.perf_counter()
        ps = fabric.path_system(comm)
        dt_route = (time.perf_counter() - t0) * 1e3
        flow = mw_concurrent_flow(ps, iters=200, warm=warm, device=dev)
        out["routing"].append({
            "switches": fabric.topology.n_switches, "n_paths": ps.n_paths,
            "digest": system_digest(ps), "alpha": flow.alpha,
            "spliced": _spliced(ps)})
        out["solves"].append({"system": ps, "warm": warm, "flow": flow})
        return ps, flow, dt_route

    # 64-pod cluster, Jellyfish inter-pod fabric (degree 6)
    fabric = make_fabric("jellyfish", n_pods=64, degree=6, seed=0, device=dev)
    mesh = plan_mesh(64 * 256, model_parallel=16, devices_per_pod=256)
    out["describe"] = [fabric.describe()]
    out["mesh"] = mesh.describe()
    print("initial fabric: ", fabric.describe())
    print("initial mesh:   ", mesh.describe())

    # route cross-pod permutation traffic; this path system is the state the
    # delta engine carries through every mutation below
    perm = random_server_permutation(fabric.topology.n_servers, seed=0)
    comm = permutation_commodities(fabric.topology, perm)
    ps, flow, dt_route = _route(fabric, comm)
    print(f"initial routing:  P={ps.n_paths} paths, alpha={flow.alpha:.3f} "
          f"({dt_route:.0f}ms, full build)")

    # pretend-train, checkpoint
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    params = {"w": torch.arange(64, dtype=torch.float32,
                                device=dev).reshape(8, 8)}
    ckpt.save(100, params, extra={"mesh": mesh.describe()}, blocking=True)

    # --- expansion: +16 pods arrive in 4-pod tranches (paper §4.2) ---
    print("\n+16 pods (4-pod tranches):")
    for tranche in range(4):
        fabric = fabric.expand(4, seed=10 + tranche)
        perm = extend_server_permutation(perm, fabric.topology.n_servers,
                                         seed=10 + tranche)
        comm = permutation_commodities(fabric.topology, perm)
        ps, flow, dt_route = _route(fabric, comm, warm=flow)
        print(f"  +4 pods -> {fabric.topology.n_switches}: "
              f"alpha={flow.alpha:.3f}, routing {dt_route:.0f}ms, "
              f"{_spliced(ps):.0%} of paths spliced from the old system")
    new_mesh, report = replan(mesh, 80 * 256)
    out["describe"].append(fabric.describe())
    out["replan"] = [report]
    print("  fabric:       ", fabric.describe())
    print("  mesh replan:  ", report)
    restored, extra = ckpt.restore_latest(target=params)
    out["restored"] = {"step": extra["step"],
                       "shape": tuple(restored["w"].shape),
                       "equal": bool(torch.equal(restored["w"].cpu(),
                                                 params["w"].cpu()))}
    print(f"  checkpoint from step {extra['step']} restores onto the new mesh "
          f"(shape {tuple(restored['w'].shape)})")

    # --- failure: 5% of inter-pod links fail (paper §4.3) ---
    fabric = fabric.fail(0.05, seed=3)
    ps, flow, dt_route = _route(fabric, comm, warm=flow)
    out["describe"].append(fabric.describe())
    print("\n5% links failed:")
    print("  fabric:       ", fabric.describe())
    print(f"  routing delta:  alpha={flow.alpha:.3f} "
          f"(routing {dt_route:.0f}ms, {_spliced(ps):.0%} of paths spliced)")

    # --- and a pod dies outright ---
    fabric = fabric.remove(pod=3, seed=2)
    emb = fabric.ring()
    new_mesh2, report2 = replan(new_mesh, 79 * 256)
    out["describe"].append(fabric.describe())
    out["ring"] = emb.summary()
    out["replan"].append(report2)
    print("\npod 3 lost:")
    print("  fabric:       ", fabric.describe())
    print("  re-embedded ring:", emb.summary())
    print("  mesh replan:  ", report2)
    print("\nthe degraded fabric is just a smaller random graph — training "
          "resumes from the checkpoint without operator intervention.")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the demo checkpoint goes (default: a "
                    "temporary directory, removed at the end)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if args.checkpoint_dir is not None:
        return run(dev, args.checkpoint_dir)
    with tempfile.TemporaryDirectory() as tmp:
        return run(dev, tmp)


if __name__ == "__main__":
    main()
