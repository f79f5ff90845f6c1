"""Incremental expansion, failures and delta routing: port against reference.

Everything here is exact apart from the LP/MW objectives:

* every mutation producer (``expand_to``, ``add_switch``, ``remove_switch``,
  ``rewire_free_ports``, ``fail_links``, ``fail_switches``, ``heal_links``)
  gives the reference's topology (``edge_fingerprint``, ports, degrees) and
  the same ``meta`` delta records, because the numpy modules are carried
  over with the same RNG call order;
* along mutation chains the port's ``update_path_system`` equals the port's
  rebuild and the reference's own delta update array for array (path sets,
  slot tables, row order, ``unrouted``, ``row_map``), below 384 switches
  (where the delta recomputes APSP) and above (where it repairs and
  certifies the old matrix);
* LP alphas of equal path systems agree to 1e-6, the bound the reference's
  own delta tests use;
* the Fig 5 and Fig 7 paper claims hold for the port, and the LEGUP and
  Jellyfish expansion arcs give the reference's ``ArcPoint`` values (the
  Kernighan-Lin bisection is float64 numpy, so they are equal).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core.traffic import Commodities as RCommodities
import repro_torch.core as T
from repro_torch import convert, obs
from repro_torch.core import routing as port_routing
from repro_torch.core.expansion import _Mut
from repro_torch.core.traffic import Commodities

CPU = "cpu"


def _same_topology(pt, rt):
    __tracebackhide__ = True
    assert T.edge_fingerprint(pt) == R.edge_fingerprint(rt)
    assert pt.n_switches == rt.n_switches
    np.testing.assert_array_equal(pt.ports, rt.ports)
    np.testing.assert_array_equal(pt.net_degree, rt.net_degree)
    assert pt.name == rt.name
    assert pt.meta == rt.meta


def _same_system(a, b, row_map=True):
    """Array-for-array equality of two path systems (either package)."""
    __tracebackhide__ = True
    assert a.n_edges == b.n_edges
    assert a.n_commodities == b.n_commodities
    assert a.n_paths == b.n_paths
    np.testing.assert_array_equal(a.unrouted, b.unrouted)
    w = max(a.path_edges.shape[1], b.path_edges.shape[1])
    pa = np.full((a.n_paths, w), 2 * a.n_edges, dtype=np.int32)
    pa[:, : a.path_edges.shape[1]] = a.path_edges
    pb = np.full((b.n_paths, w), 2 * b.n_edges, dtype=np.int32)
    pb[:, : b.path_edges.shape[1]] = b.path_edges
    np.testing.assert_array_equal(pa, pb)
    for f in ("path_len", "path_owner", "demands", "capacities", "src",
              "dst"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.k, a.max_slack) == (b.k, b.max_slack)
    if row_map:
        if a.row_map is None or b.row_map is None:
            assert a.row_map is None and b.row_map is None
        else:
            np.testing.assert_array_equal(a.row_map, b.row_map)


def _assert_equivalent(ps, full):
    """The reference test's ``_assert_equivalent``: a delta update equals a
    rebuild row for row, and their LP alphas agree to 1e-6."""
    __tracebackhide__ = True
    _same_system(ps, full, row_map=False)
    if ps.n_paths:
        a1 = T.lp_concurrent_flow(ps).alpha
        a2 = T.lp_concurrent_flow(full).alpha
        assert a1 == pytest.approx(a2, abs=1e-6)


# --------------------------------------------------------------------------- #
# producers: identical topologies and delta records
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(5))
def test_producers_match_reference(seed):
    rt = R.jellyfish(22, 9, 6, seed=seed)
    pt = T.jellyfish(22, 9, 6, seed=seed)
    _same_topology(pt, rt)
    victim = seed * 3 % rt.n_switches
    pairs = [
        (T.expand_to(pt, 27, seed=seed), R.expand_to(rt, 27, seed=seed)),
        (T.add_switch(pt, 9, 6, seed=seed), R.add_switch(rt, 9, 6, seed=seed)),
        (T.remove_switch(pt, victim, seed=seed),
         R.remove_switch(rt, victim, seed=seed)),
        (T.fail_links(pt, 0.1, seed=seed), R.fail_links(rt, 0.1, seed=seed)),
        (T.fail_links(pt, n_links=3, seed=seed),
         R.fail_links(rt, n_links=3, seed=seed)),
        (T.fail_switches(pt, 0.1, seed=seed),
         R.fail_switches(rt, 0.1, seed=seed)),
    ]
    pf, rf = T.fail_links(pt, 0.2, seed=seed), R.fail_links(rt, 0.2, seed=seed)
    pairs.append((T.rewire_free_ports(pf, seed=seed),
                  R.rewire_free_ports(rf, seed=seed)))
    from repro.core.failures import heal_links as r_heal
    from repro_torch.core.failures import heal_links as p_heal
    pairs.append((p_heal(pf, pf.meta["edges_removed"]),
                  r_heal(rf, rf.meta["edges_removed"])))
    for p, r in pairs:
        _same_topology(p, r)
        assert p.meta["delta_kind"] == r.meta["delta_kind"]
    # heal is the exact inverse of fail
    assert T.edge_fingerprint(pairs[-1][0]) == T.edge_fingerprint(pt)


def test_expand_to_with_shared_generator_matches_reference():
    """A generator threaded through a chain of producers draws the same
    numbers in both packages (the capacity sweeps grow topologies so)."""
    rt, pt = R.jellyfish(30, 10, 6, seed=1), T.jellyfish(30, 10, 6, seed=1)
    rr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for step in range(3):
        rt = R.expand_to(rt, rt.n_switches + 3, 10, 6, seed=rr)
        pt = T.expand_to(pt, pt.n_switches + 3, 10, 6, seed=pr)
        _same_topology(pt, rt)
        rt = R.fail_links(rt, 0.05, seed=rr)
        pt = T.fail_links(pt, 0.05, seed=pr)
        _same_topology(pt, rt)


def test_convert_copies_meta_records():
    """A topology converted from the reference shares no meta state: its
    delta records are copies down to their lists."""
    rt = R.fail_links(R.jellyfish(24, 6, 4, seed=1), 0.1, seed=2)
    fields = {f.name: getattr(rt, f.name) for f in dataclasses.fields(rt)}
    pt = convert.topology_from_numpy(fields)
    assert pt.meta == rt.meta
    assert pt.meta is not rt.meta
    assert pt.meta["edges_removed"] is not rt.meta["edges_removed"]
    before = list(rt.meta["edges_removed"])
    pt.meta["edges_removed"].append((0, 1))
    pt.meta["kind"] = "changed"
    assert rt.meta["edges_removed"] == before
    assert rt.meta["kind"] != "changed"
    # a converted topology carries the delta into the port's update
    base = convert.topology_from_numpy(dataclasses.asdict(
        R.jellyfish(24, 6, 4, seed=1)))
    pt = convert.topology_from_numpy(fields)
    comm = T.random_permutation_traffic(base, seed=0)
    ps = T.build_path_system(base, comm, k=4, device=CPU)
    _assert_equivalent(
        T.update_path_system(ps, base, pt, comm, device=CPU),
        T.build_path_system(pt, comm, k=4, cache=False, device=CPU))


# --------------------------------------------------------------------------- #
# the reference's delta-routing tests, on the port
# --------------------------------------------------------------------------- #


def _remap_comm(comm, node_remap, cls):
    nm = np.asarray(node_remap)
    keep = (nm[comm.src] >= 0) & (nm[comm.dst] >= 0)
    return cls(src=nm[comm.src[keep]], dst=nm[comm.dst[keep]],
               demand=comm.demand[keep], n_flows=int(keep.sum()))


def _mutation_chain(seed, n, k_ports, r_net, steps, k, frac=0.06, lp=True):
    """Run one randomized add/fail/remove chain through both packages in
    lockstep; at every step the port's delta update must equal the port's
    rebuild and the reference's delta update.  ``lp=False`` skips the LP
    alphas of the equal systems (HiGHS takes minutes past ~10k paths)."""
    rng = np.random.default_rng(seed)
    rt = R.jellyfish(n, k_ports, r_net, seed=seed % 97)
    pt = T.jellyfish(n, k_ports, r_net, seed=seed % 97)
    perm = R.random_server_permutation(rt.n_servers, seed=seed % 89)
    rc = R.permutation_commodities(rt, perm)
    pc = T.permutation_commodities(pt, perm)
    rps = R.build_path_system(rt, rc, k=k)
    pps = T.build_path_system(pt, pc, k=k, device=CPU)
    _same_system(pps, rps)
    for _ in range(steps):
        kind = int(rng.integers(0, 3))
        s1, s2 = int(rng.integers(1 << 30)), int(rng.integers(1 << 30))
        if kind == 0:
            rn = R.add_switch(rt, k_ports, r_net, seed=s1)
            pn = T.add_switch(pt, k_ports, r_net, seed=s1)
            perm = R.extend_server_permutation(perm, rn.n_servers, seed=s2)
            rc = R.permutation_commodities(rn, perm)
            pc = T.permutation_commodities(pn, perm)
        elif kind == 1:
            rn = R.fail_links(rt, frac, seed=s1)
            pn = T.fail_links(pt, frac, seed=s1)
        else:
            victim = int(rng.integers(rt.n_switches))
            rn = R.remove_switch(rt, victim, seed=s1)
            pn = T.remove_switch(pt, victim, seed=s1)
            rc = _remap_comm(rc, rn.meta["node_remap"], RCommodities)
            pc = _remap_comm(pc, pn.meta["node_remap"], Commodities)
            perm = R.random_server_permutation(rn.n_servers, seed=s2)
        _same_topology(pn, rn)
        rps = R.update_path_system(rps, rt, rn, rc)
        pps = T.update_path_system(pps, pt, pn, pc, device=CPU)
        _same_system(pps, rps)
        full = T.build_path_system(pn, pc, k=k, cache=False, device=CPU)
        if lp:
            _assert_equivalent(pps, full)
        else:
            _same_system(pps, full, row_map=False)
        rt, pt = rn, pn


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_update_equals_build_over_mutation_chain(seed):
    _mutation_chain(seed * 104729 + 11, 26, 8, 5, steps=4, k=4)


def test_update_repairs_apsp_above_384_switches(monkeypatch):
    """At 400+ switches the delta repairs the cached APSP and certifies it
    (``_repair_dist`` + ``_dist_is_exact``) instead of recomputing it; the
    result still equals the rebuild and the reference's update."""
    calls = {"repair": 0, "exact": 0}
    repair, exact = port_routing._repair_dist, port_routing._dist_is_exact

    def spy_repair(*a, **kw):
        calls["repair"] += 1
        return repair(*a, **kw)

    def spy_exact(*a, **kw):
        calls["exact"] += 1
        return exact(*a, **kw)

    monkeypatch.setattr(port_routing, "_repair_dist", spy_repair)
    monkeypatch.setattr(port_routing, "_dist_is_exact", spy_exact)
    rebuilds = obs.counter("route/update/rebuilds").to_value()
    _mutation_chain(7, 400, 12, 8, steps=4, k=8, frac=0.03, lp=False)
    assert calls["repair"] >= 3 and calls["exact"] == calls["repair"]
    assert obs.counter("route/update/rebuilds").to_value() == rebuilds


def test_update_handles_disconnection_and_reconnection():
    """Commodities crossing a cut become unrouted and return after repair."""
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (3, 4)]
    top = T.Topology.regular(8, 5, 3, edges)
    comm = Commodities(src=np.array([0, 1, 4]), dst=np.array([3, 6, 7]),
                       demand=np.ones(3), n_flows=3)
    ps = T.build_path_system(top, comm, k=4, device=CPU)
    assert not ps.unrouted.any()
    cut = top.with_edges([e for e in edges if e != (3, 4)])
    ps_cut = T.update_path_system(ps, top, cut, comm, device=CPU)
    _assert_equivalent(ps_cut, T.build_path_system(cut, comm, k=4,
                                                   cache=False, device=CPU))
    assert ps_cut.unrouted.tolist() == [False, True, False]
    ps_back = T.update_path_system(ps_cut, cut, top, comm, device=CPU)
    _assert_equivalent(ps_back, T.build_path_system(top, comm, k=4,
                                                    cache=False, device=CPU))
    assert not ps_back.unrouted.any()


def test_update_with_changed_commodity_set():
    """Pairs may appear/disappear between updates; demands may change."""
    top = T.jellyfish(24, 8, 5, seed=3)
    comm1 = T.random_permutation_traffic(top, seed=0)
    ps = T.build_path_system(top, comm1, k=4, device=CPU)
    tn = T.fail_links(top, 0.05, seed=1)
    comm2 = T.random_permutation_traffic(tn, seed=7)
    ps2 = T.update_path_system(ps, top, tn, comm2, device=CPU)
    _assert_equivalent(ps2, T.build_path_system(tn, comm2, k=4, cache=False,
                                                device=CPU))


def test_update_falls_back_on_large_delta():
    top = T.jellyfish(30, 8, 5, seed=0)
    comm = T.random_permutation_traffic(top, seed=0)
    ps = T.build_path_system(top, comm, k=4, device=CPU)
    wrecked = T.fail_links(top, 0.6, seed=2)
    rebuilds = obs.counter("route/update/rebuilds").to_value()
    ps2 = T.update_path_system(ps, top, wrecked, comm, device=CPU)
    assert obs.counter("route/update/rebuilds").to_value() == rebuilds + 1
    full = T.build_path_system(wrecked, comm, k=4, cache=False, device=CPU)
    assert np.array_equal(ps2.unrouted, full.unrouted)
    if ps2.n_paths:
        assert T.lp_concurrent_flow(ps2).alpha == pytest.approx(
            T.lp_concurrent_flow(full).alpha, abs=1e-6)


def test_update_requires_relatable_topologies():
    """Unrelatable shrink (no recorded remap) degrades to a full rebuild."""
    a = T.jellyfish(20, 8, 5, seed=0)
    b = T.jellyfish(18, 8, 5, seed=1)
    comm_b = T.random_permutation_traffic(b, seed=0)
    comm_a = T.random_permutation_traffic(a, seed=0)
    ps = T.build_path_system(a, comm_a, k=4, device=CPU)
    ps2 = T.update_path_system(ps, a, b, comm_b, device=CPU)
    _assert_equivalent(ps2, T.build_path_system(b, comm_b, k=4, cache=False,
                                                device=CPU))


@pytest.mark.parametrize("seed", [3, 77, 1234, 98765, 555555])
def test_producers_record_exact_edge_delta(seed):
    top = T.jellyfish(22, 9, 6, seed=seed % 53)
    muts = [
        T.add_switch(top, 9, 6, seed=seed),
        T.fail_links(top, 0.1, seed=seed),
        T.fail_switches(top, 0.1, seed=seed),
        T.remove_switch(top, seed % top.n_switches, seed=seed),
        T.rewire_free_ports(T.fail_links(top, 0.1, seed=seed), seed=seed),
    ]
    checked = 0
    for tn in muts:
        assert tn.meta["delta_parent"] is not None
        if tn.meta["delta_parent"] != T.edge_fingerprint(top):
            continue  # rewire-of-failed: its parent is the failed topology
        added, removed_mask, _ = T.edge_delta(top, tn, tn.meta.get("node_remap"))
        assert sorted(map(tuple, added.tolist())) == sorted(
            tn.meta["edges_added"])
        assert sorted(map(tuple, top.edges[removed_mask].tolist())) == sorted(
            tn.meta["edges_removed"])
        checked += 1
    assert checked == 4


def test_expand_to_delta_relative_to_base():
    top = T.jellyfish(20, 8, 5, seed=0)
    grown = T.expand_to(top, 26, seed=1)
    assert grown.meta["delta_parent"] == T.edge_fingerprint(top)
    added, removed_mask, _ = T.edge_delta(top, grown)
    assert sorted(map(tuple, added.tolist())) == sorted(
        grown.meta["edges_added"])
    assert sorted(map(tuple, top.edges[removed_mask].tolist())) == sorted(
        grown.meta["edges_removed"])


def test_rewire_and_mut_invariants():
    top = T.jellyfish(30, 10, 6, seed=1)
    failed = T.fail_links(top, 0.2, seed=2)
    a = T.rewire_free_ports(failed, seed=5)
    assert np.array_equal(a.edges, T.rewire_free_ports(failed, seed=5).edges)
    a.validate()
    mut = _Mut(top.copy())
    u, v = map(int, top.edges[0])
    with pytest.raises(ValueError, match="already exists"):
        mut.add(u, v)
    with pytest.raises(ValueError, match="self-loop"):
        mut.add(u, u)


def test_mw_warm_start_matches_cold_quality():
    top = T.jellyfish(30, 10, 6, seed=2)
    comm = T.random_permutation_traffic(top, seed=0)
    ps = T.build_path_system(top, comm, k=8, device=CPU)
    cold0 = T.mw_concurrent_flow(ps, iters=150, device=CPU)
    tn = T.fail_links(top, 0.05, seed=1)
    ps2 = T.update_path_system(ps, top, tn, comm, device=CPU)
    assert ps2.row_map is not None and (ps2.row_map >= 0).any()
    warm = T.mw_concurrent_flow(ps2, iters=60, warm=cold0, device=CPU)
    cold = T.mw_concurrent_flow(ps2, iters=150, device=CPU)
    assert warm.alpha >= 0.9 * cold.alpha
    loads = ps2.loads(warm.rates)
    assert (loads <= ps2.capacities * (1 + 1e-4)).all()


# --------------------------------------------------------------------------- #
# the paper's Fig 5 and Fig 7 claims, on the port
# --------------------------------------------------------------------------- #


def _alpha_lp(top, seed=0, k=8, normalized=True):
    comm = T.random_permutation_traffic(top, seed=seed)
    ps = T.build_path_system(top, comm, k=k, device=CPU)
    res = T.lp_concurrent_flow(ps)
    return res.normalized_throughput() if normalized else res.alpha


def test_incremental_equals_scratch_capacity():
    """Fig 5: incrementally grown Jellyfish ~ from-scratch throughput."""
    base = T.jellyfish(20, 12, 8, seed=0)
    grown = T.expand_to(base, 40, 12, 8, seed=1)
    scratch = T.jellyfish(40, 12, 8, seed=2)
    a_grown = np.mean([_alpha_lp(grown, seed=s) for s in range(2)])
    a_scratch = np.mean([_alpha_lp(scratch, seed=s) for s in range(2)])
    assert a_grown == pytest.approx(a_scratch, abs=0.08)


def test_failure_resilience_better_than_proportional():
    """Fig 7: failing 15% of links loses < 16% capacity."""
    top = T.jellyfish(60, 13, 10, seed=3)
    base = np.mean([_alpha_lp(top, seed=s, normalized=False)
                    for s in range(2)])
    failed = T.fail_links(top, 0.15, seed=4)
    after = np.mean([_alpha_lp(failed, seed=s, normalized=False)
                     for s in range(2)])
    assert base >= 1.0
    assert after / base >= 1 - 0.16


# --------------------------------------------------------------------------- #
# Fig 6 expansion economics: leaf-spine Clos and the LEGUP arcs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("leaves,spines", [(10, 4), (30, 8)])
def test_build_clos_matches_reference(leaves, spines):
    rs = R.ClosSpec(leaves, 16, 8, spines, 24)
    ps = T.ClosSpec(leaves, 16, 8, spines, 24)
    _same_topology(T.build_clos(ps), R.build_clos(rs))
    assert ps.ideal_bisection() == rs.ideal_bisection()


def test_expansion_arcs_match_reference():
    stages = [(0.0, 160), (20_000.0, 80), (10_000.0, 0), (15_000.0, 0)]
    r_st = [R.ExpansionStage(b, s) for b, s in stages]
    p_st = [T.ExpansionStage(b, s) for b, s in stages]
    for fn in ("legup_arc", "jellyfish_arc"):
        kw = ({"servers_per_leaf": 16} if fn == "legup_arc"
              else {"servers_per_switch": 16, "seed": 0})
        want = getattr(R, fn)(r_st, k_ports=24, **kw)
        got = getattr(T, fn)(p_st, k_ports=24, **kw)
        assert [dataclasses.asdict(p) for p in got] == \
            [dataclasses.asdict(p) for p in want]
