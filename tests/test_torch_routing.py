"""Topologies, traffic, APSP and path systems: port against reference.

Everything here is exact: seeded topologies (``edge_fingerprint``), traffic,
the canonical int16 hop matrix from every APSP backend, enumerated path
sets, slot tables and their row order.  The reference's own contract
checks (``repro.analysis.contracts``, numpy only) are run on the port's
outputs.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.analysis import contracts as ref_contracts
from repro.core import routing as ref_routing
import repro_torch.core as T
from repro_torch import convert
from repro_torch.analysis import contracts as port_contracts
from repro_torch.core import routing as port_routing


@pytest.mark.parametrize("n,k,r,seed", [(16, 6, 4, 0), (40, 8, 5, 3),
                                        (80, 12, 7, 11)])
def test_jellyfish_fingerprint(n, k, r, seed):
    assert (T.edge_fingerprint(T.jellyfish(n, k, r, seed=seed))
            == R.edge_fingerprint(R.jellyfish(n, k, r, seed=seed)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heterogeneous_fingerprint(seed):
    ports = np.array([8] * 20 + [12] * 20)
    servers = np.array([3] * 20 + [5] * 20)
    pt = T.jellyfish_heterogeneous(ports, servers, seed=seed)
    rt = R.jellyfish_heterogeneous(ports, servers, seed=seed)
    assert T.edge_fingerprint(pt) == R.edge_fingerprint(rt)
    np.testing.assert_array_equal(pt.servers_per_switch, rt.servers_per_switch)


@pytest.mark.parametrize("k", [4, 6, 8])
def test_fattree_fingerprint(k):
    assert T.edge_fingerprint(T.fattree(k)) == R.edge_fingerprint(R.fattree(k))
    assert T.fattree_equipment(k) == R.fattree_equipment(k)


def test_permutation_traffic_identical():
    rt = R.jellyfish(30, 8, 5, seed=2)
    pt = T.jellyfish(30, 8, 5, seed=2)
    for seed in range(3):
        rc = R.random_permutation_traffic(rt, seed=seed)
        pc = T.random_permutation_traffic(pt, seed=seed)
        for f in ("src", "dst", "demand"):
            np.testing.assert_array_equal(getattr(pc, f), getattr(rc, f))
        assert pc.n_flows == rc.n_flows


def test_convert_topology_round_trip():
    rt = R.jellyfish(24, 6, 4, seed=1)
    pt = convert.topology_from_numpy(dataclasses.asdict(rt))
    assert T.edge_fingerprint(pt) == R.edge_fingerprint(rt)
    assert pt.edges is not rt.edges


@pytest.mark.parametrize("backend", ["dense", "blocked", "minplus",
                                     "minplus_blocked", "auto"])
def test_apsp_hops_every_backend(backend):
    rt = R.jellyfish(70, 8, 5, seed=4)
    adj = rt.adjacency()
    prev_r = ref_routing.set_apsp_backend("dense")
    prev_p = port_routing.set_apsp_backend(backend)
    try:
        want = ref_routing._apsp(adj)
        got = port_routing._apsp(adj, diameter_hint=5, device="cpu")
    finally:
        ref_routing.set_apsp_backend(prev_r)
        port_routing.set_apsp_backend(prev_p)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    port_contracts.check_hop_matrix(got, 70)
    ref_contracts.check_hop_matrix(got, 70)


@pytest.mark.parametrize("backend", ["dense", "minplus", "minplus_blocked"])
def test_apsp_disconnected(backend):
    rt = R.Topology.regular(10, 4, 3, [(0, 1), (1, 2), (3, 4), (5, 6), (6, 7)])
    adj = rt.adjacency()
    prev = port_routing.set_apsp_backend(backend)
    try:
        got = port_routing._apsp(adj, device="cpu")
    finally:
        port_routing.set_apsp_backend(prev)
    np.testing.assert_array_equal(got, ref_routing._apsp(adj))


def _same_path_system(pps, rps):
    for f in ("path_edges", "path_len", "path_owner", "demands",
              "capacities", "unrouted", "src", "dst"):
        np.testing.assert_array_equal(getattr(pps, f), getattr(rps, f),
                                      err_msg=f)
    assert pps.n_commodities == rps.n_commodities
    assert pps.n_edges == rps.n_edges


@pytest.mark.parametrize("admission", ["auto", "numpy", "kernel"])
@pytest.mark.parametrize("kind,k,slack", [("jellyfish", 8, 3),
                                          ("jellyfish", 4, 4),
                                          ("fattree", 8, 2)])
def test_build_path_system_identical(kind, k, slack, admission):
    if kind == "jellyfish":
        rt = R.jellyfish(60, 10, 6, seed=7)
        pt = T.jellyfish(60, 10, 6, seed=7)
    else:
        rt, pt = R.fattree(6), T.fattree(6)
    rc = R.random_permutation_traffic(rt, seed=3)
    pc = T.random_permutation_traffic(pt, seed=3)
    rps = R.build_path_system(rt, rc, k=k, max_slack=slack, cache=False)
    prev = port_routing.set_admission_backend(admission)
    try:
        pps = T.build_path_system(pt, pc, k=k, max_slack=slack, cache=False,
                                  device="cpu")
    finally:
        port_routing.set_admission_backend(prev)
    _same_path_system(pps, rps)
    # the reference's CT checks on the port's output (CT-build geometry and
    # canonical tie order)
    ref_contracts.check_path_system(pps, rt, name="port build")
    port_contracts.check_path_system(pps, pt, name="port build")


def test_unrouted_commodities_identical():
    edges = [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 7)]
    rt = R.Topology.regular(8, 4, 2, edges)
    pt = T.Topology.regular(8, 4, 2, edges)
    rc = R.random_permutation_traffic(rt, seed=0)
    pc = T.random_permutation_traffic(pt, seed=0)
    rps = R.build_path_system(rt, rc, k=4, cache=False)
    pps = T.build_path_system(pt, pc, k=4, cache=False, device="cpu")
    _same_path_system(pps, rps)
    assert pps.unrouted.any()


def test_k_shortest_paths_identical():
    rt = R.jellyfish(40, 8, 5, seed=9)
    pt = T.jellyfish(40, 8, 5, seed=9)
    pairs = [(0, 39), (39, 0), (5, 5), (3, 17), (17, 3), (3, 17)]
    want = R.k_shortest_paths(rt, pairs, k=6, max_slack=3, cache=False)
    got = T.k_shortest_paths(pt, pairs, k=6, max_slack=3, cache=False,
                             device="cpu")
    assert got == want


def test_convert_path_system_feeds_identical_state():
    rt = R.jellyfish(30, 8, 5, seed=1)
    rps = R.build_path_system(rt, R.random_permutation_traffic(rt, seed=0))
    pps = convert.path_system_from_numpy(dataclasses.asdict(rps))
    _same_path_system(pps, rps)
    assert not np.shares_memory(pps.path_edges, rps.path_edges)
    with pytest.raises(ValueError, match="unknown fields"):
        convert.path_system_from_numpy({"bogus": 1})


def test_entry_points_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")
    pt = T.jellyfish(16, 6, 4, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        T.build_path_system(pt, T.random_permutation_traffic(pt, seed=0))
