"""Quickstart on the PyTorch port: build a Jellyfish, compare it with a
fat-tree, expand it, break it, and route traffic over it — the paper's
§3–§4 in one script.

The counterpart of ``examples/quickstart.py`` through ``repro_torch``:
path systems are built on ``--device`` (APSP and the admission prunes on
the card's kernels), the LP solves run on the host (scipy / HiGHS, as in
the reference) and fluid MPTCP runs on ``--device``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``main()`` returns the readings it prints.
"""

import argparse

import numpy as np

from repro_torch.core import (
    bollobas_bound,
    build_path_system,
    expand_to,
    fail_links,
    fattree,
    fattree_equipment,
    jellyfish_heterogeneous,
    lp_concurrent_flow,
    mptcp_throughput,
    path_stats,
    random_permutation_traffic,
)
from repro_torch.device import resolve


def alpha(top, dev, seed=0, k=8):
    comm = random_permutation_traffic(top, seed=seed)
    ps = build_path_system(top, comm, k=k, device=dev)
    return lp_concurrent_flow(ps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve(ap.parse_args(argv).device)
    out = {}

    # 1. the fat-tree baseline: k=8 -> 80 switches, 128 servers
    ft = fattree(8)
    eq = fattree_equipment(8)
    out["fattree"] = (ft.describe(), str(path_stats(ft)))
    print("fat-tree:   ", ft.describe())
    print("  paths:    ", path_stats(ft))

    # 2. same equipment as Jellyfish, 15% more servers
    n_servers = int(eq["servers"] * 1.15)
    servers = np.full(eq["switches"], n_servers // eq["switches"])
    servers[: n_servers - servers.sum()] += 1
    jf = jellyfish_heterogeneous(np.full(eq["switches"], 8), servers, seed=0)
    out["jellyfish"] = (jf.describe(), str(path_stats(jf)))
    out["bollobas"] = bollobas_bound(8, 6)
    print("jellyfish:  ", jf.describe())
    print("  paths:    ", path_stats(jf))
    print(f"  bollobas bisection bound (k=8, r=6): {out['bollobas']:.3f}")

    # 3. both at full capacity under random permutation traffic?
    out["fattree_alpha"] = alpha(ft, dev, k=32).alpha
    out["jellyfish_alpha"] = alpha(jf, dev).alpha
    print(f"  fat-tree alpha = {out['fattree_alpha']:.3f} "
          f"({eq['servers']} servers)")
    print(f"  jellyfish alpha = {out['jellyfish_alpha']:.3f} "
          f"({n_servers} servers, same switches)")

    # 4. incremental expansion: +20 racks, throughput preserved
    grown = expand_to(jf, jf.n_switches + 20, 8, 6, seed=1)
    out["expanded"] = grown.describe()
    out["grown_alpha"] = alpha(grown, dev).alpha
    print("expanded:   ", grown.describe())
    print(f"  alpha after growth = {out['grown_alpha']:.3f}")

    # 5. failures: 9% of links die; capacity degrades gracefully
    broken = fail_links(jf, 0.09, seed=2)
    out["failed_alpha"] = alpha(broken, dev).alpha
    print(f"  alpha with 9% links failed = {out['failed_alpha']:.3f}")

    # 6. MPTCP-style routing on k=8 shortest paths
    comm = random_permutation_traffic(jf, seed=3)
    mp = mptcp_throughput(build_path_system(jf, comm, k=8, device=dev),
                          device=dev)
    out["mptcp"] = (mp.mean_throughput, mp.jain_index)
    print(f"  fluid-MPTCP mean throughput = {mp.mean_throughput:.3f} "
          f"(jain fairness {mp.jain_index:.3f})")
    return out


if __name__ == "__main__":
    main()
