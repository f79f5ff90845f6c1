"""The port's Fig 1c driver end to end against the reference's.

``max_servers_at_full_capacity`` at the equipment of the k=4 and k=6
fat-trees gives the reference's server count exactly: both under ``auto``
(exact LP verdicts on identical path systems) and under ``method="mw"``
(the batched MW solver; alpha differs from the reference only in the last
bits of transcendentals, and no probe here sits that close to 1).  The
port also passes its own copy of the paper-claims test of Fig 1c.
"""

import numpy as np
import pytest

from benchmarks.common import max_servers_at_full_capacity as ref_max_servers
from repro_torch import capacity
from repro_torch.core import (
    build_path_system,
    fattree,
    fattree_equipment,
    jellyfish_heterogeneous,
    lp_concurrent_flow,
    random_permutation_traffic,
)

CPU = "cpu"


@pytest.mark.parametrize("k,method", [(4, "auto"), (4, "mw"), (6, "auto"),
                                      (6, "mw")])
def test_max_servers_matches_reference(k, method):
    eq = fattree_equipment(k)
    args = dict(lo=eq["servers"] // 2, hi=2 * eq["servers"], seeds=(0,),
                method=method, iters=300)
    want = ref_max_servers(eq["switches"], eq["ports_per_switch"], **args)
    got = capacity.max_servers_at_full_capacity(
        eq["switches"], eq["ports_per_switch"], device=CPU, **args)
    assert got == want


def test_wave_levels_equal_sequential():
    kw = dict(seeds=(0, 1), n_matrices=2, k=4, method="mw", iters=150,
              mw_backend="gather", device=CPU)
    seq = capacity.max_servers_at_full_capacity(12, 8, 10, 30, **kw)
    wave = capacity.max_servers_at_full_capacity(12, 8, 10, 30,
                                                 wave_levels=2, **kw)
    assert seq == wave


def test_alpha_helpers_agree():
    top = capacity.jellyfish_same_equipment(20, 8, 60, seed=0)
    lp = capacity.alpha_of(top, seed=1, device=CPU)
    comm = random_permutation_traffic(top, seed=1)
    ps = build_path_system(top, comm, k=8, max_slack=3, device=CPU)
    assert lp == lp_concurrent_flow(ps).alpha
    assert capacity.batch_alphas([ps], device=CPU) == [lp]
    mw = capacity.batch_alphas([ps, ps], method="mw", iters=200, device=CPU)
    assert mw[0] == mw[1] <= lp * (1 + 1e-6)
    assert capacity.spread_servers(10, 4).tolist() == [3, 3, 2, 2]


def test_probe_reports_the_solves_behind_its_verdict():
    top = capacity.jellyfish_same_equipment(20, 8, 60, seed=0)
    kw = dict(n_matrices=2, k=4, method="mw", iters=150, device=CPU)
    probe = capacity.probe_full_capacity(top, **kw)
    assert probe.verdict == capacity.supports_full_capacity(top, **kw)
    assert len(probe.mw_systems) == len(probe.mw_results) == 2
    assert probe.verdict == all(r.alpha >= 1.0 - 1e-6
                                for r in probe.mw_results)
    want = capacity.batch_alphas(probe.mw_systems, method="mw", iters=150,
                                 target_alpha=1.0, device=CPU)
    assert [r.alpha for r in probe.mw_results] == want
    lp = capacity.probe_full_capacity(top, n_matrices=2, k=4, device=CPU)
    assert lp.mw_systems == lp.mw_results == []


def _alpha(top, seed=0, k=8):
    comm = random_permutation_traffic(top, seed=seed)
    ps = build_path_system(top, comm, k=k, device=CPU)
    return lp_concurrent_flow(ps).normalized_throughput()


def test_jellyfish_beats_fattree_servers_at_full_capacity():
    """Core claim (Fig 1c), the port's copy of the paper-claims test: on the
    k=8 fat-tree's 80 switches of 8 ports, Jellyfish carries 1.15x the
    fat-tree's servers at full capacity."""
    k = 8
    ft = fattree(k)
    eq = fattree_equipment(k)
    comm = random_permutation_traffic(ft, seed=0)
    ps = build_path_system(ft, comm, k=32, max_slack=4, device=CPU)
    assert lp_concurrent_flow(ps).alpha >= 1.0 - 1e-6

    n_sw, ports = eq["switches"], eq["ports_per_switch"]
    target = int(eq["servers"] * 1.15)
    per = target // n_sw
    extra = target - per * n_sw
    servers = np.full(n_sw, per)
    servers[:extra] += 1
    ok = 0
    for seed in range(3):
        top = jellyfish_heterogeneous(np.full(n_sw, ports), servers, seed=seed)
        ok += _alpha(top, seed=seed) >= 1.0 - 1e-6
    assert ok >= 2, "jellyfish failed to carry +15% servers at full capacity"
