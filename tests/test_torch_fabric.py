"""The fabric layer: port (``repro_torch.fabric``) against the reference.

Everything here is exact.  Both packages build the same seeded topologies
(equal by ``edge_fingerprint``); on the CPU the port's hop matrix is the
host BFS through the routing cache and its admission prune is numpy, so:

* ring embeddings (order, hop paths, stretch, congestion, efficiency) equal
  the reference's, with and without a ``members`` subset, after a 10 % link
  failure and on fat-trees;
* all-to-all scores and every collective cost model are equal bit for bit;
* a ``FabricModel`` chain ``path_system`` -> ``fail`` -> ``expand`` ->
  ``remove`` gives, at each step, the reference chain's path system and the
  port's own rebuild, array for array;
* the hop matrix the embedding reads on a card (``hops_to_f32`` of the
  int16 min-plus APSP, run here through its plain version) equals
  ``apsp_hops``.

The reference's own ``tests/test_fabric.py`` cases are mirrored at the end.
"""

import inspect

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.fabric as R
import repro_torch.core as TC
import repro_torch.fabric as T
from repro.core.metrics import apsp_hops as ref_apsp_hops
from repro_torch.core import routing as port_routing
from repro_torch.core.metrics import hops_to_f32
from repro_torch.core.traffic import Commodities
from repro_torch.device import resolve
from repro_torch.fabric import embedding as port_embedding
from repro_torch.kernels import ops

CPU = "cpu"
CPU_DEV = resolve(CPU)


def _same_embedding(p, r):
    __tracebackhide__ = True
    np.testing.assert_array_equal(p.order, r.order)
    assert p.hop_paths == r.hop_paths
    assert (p.stretch, p.congestion, p.efficiency) == (
        r.stretch, r.congestion, r.efficiency)
    assert p.summary() == r.summary()


def _same_system(a, b):
    """Array-for-array equality of two path systems (either package)."""
    __tracebackhide__ = True
    assert (a.n_edges, a.n_commodities, a.n_paths) == (
        b.n_edges, b.n_commodities, b.n_paths)
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


def _fabrics(kind="jellyfish", **kw):
    p = T.make_fabric(kind, device=CPU, **kw)
    r = R.make_fabric(kind, **kw)
    assert TC.edge_fingerprint(p.topology) == RC.edge_fingerprint(r.topology)
    assert p.name == r.name
    return p, r


def _members(pods: int) -> np.ndarray:
    rng = np.random.default_rng(pods)
    return np.sort(rng.choice(pods, size=max(pods // 2, 4), replace=False))


# --------------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("subset", [False, True], ids=["all", "members"])
@pytest.mark.parametrize("pods", [16, 64, 200])
def test_embed_ring_equals_reference(pods, subset):
    p, r = _fabrics(n_pods=pods, degree=8, seed=0)
    members = _members(pods) if subset else None
    _same_embedding(p.ring(members), r.ring(members))
    # the functional form with a seed other than 0
    _same_embedding(
        T.embed_ring(p.topology, members, seed=3, device=CPU),
        R.embed_ring(r.topology, members, seed=3),
    )


@pytest.mark.parametrize("pods", [16, 64, 200])
def test_embed_ring_after_failure_equals_reference(pods):
    p, r = _fabrics(n_pods=pods, degree=8, seed=0)
    pf, rf = p.fail(0.1, seed=1), r.fail(0.1, seed=1)
    assert TC.edge_fingerprint(pf.topology) == RC.edge_fingerprint(rf.topology)
    _same_embedding(pf.ring(), rf.ring())


@pytest.mark.parametrize("pods,k", [(8, 4), (18, 6)])
def test_fattree_ring_equals_reference(pods, k):
    p, r = _fabrics("fattree", n_pods=pods)
    assert p.name == f"fattree-fabric(k={k})"
    # the ring covers all of the fat-tree's switches, as in the reference
    assert p.topology.n_switches == 5 * k * k // 4
    _same_embedding(p.ring(), r.ring())


@pytest.mark.parametrize("pods", [16, 64])
def test_all_to_all_congestion_equals_reference(pods):
    p, r = _fabrics(n_pods=pods, degree=8, seed=0)
    assert T.all_to_all_congestion(p.topology, device=CPU) == \
        R.all_to_all_congestion(r.topology)
    assert p.a2a_efficiency() == r.a2a_efficiency()
    members = _members(pods)
    assert p.a2a_efficiency(members) == r.a2a_efficiency(members)


def test_describe_and_ring_link_equal_reference():
    p, r = _fabrics(n_pods=32, degree=6, seed=4)
    assert p.describe() == r.describe()
    lp, lr = p.ring_link(), r.ring_link()
    assert (lp.bandwidth, lp.latency, lp.efficiency) == (
        lr.bandwidth, lr.latency, lr.efficiency)
    # the cached ring is reused, a refresh gives the same embedding
    assert p.ring() is p.ring()
    _same_embedding(p.ring(refresh=True), r.ring())


@pytest.mark.parametrize("pods", [1, 2])
def test_degenerate_pair_fabric_equals_reference(pods):
    p, r = _fabrics(n_pods=pods, degree=4, seed=0)
    assert p.topology.meta == r.topology.meta == {"kind": "pair"}
    assert p.topology.name == r.topology.name == f"pair({pods})"
    if pods == 2:
        _same_embedding(p.ring(), r.ring())


def test_disconnected_fabric_raises_like_reference():
    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3)]
    pt = TC.Topology.regular(6, 3, 2, edges)
    rt = RC.Topology.regular(6, 3, 2, edges)
    with pytest.raises(ValueError, match="disconnected"):
        R.embed_ring(rt)
    with pytest.raises(ValueError, match="disconnected"):
        T.embed_ring(pt, device=CPU)
    # all-to-all scores an unroutable pair as inf in both
    assert T.all_to_all_congestion(pt, device=CPU) == \
        R.all_to_all_congestion(rt) == float("inf")


def test_nearest_neighbor_breaks_ties_like_a_set_min():
    """The port's argmin tour equals the reference's ``min`` over a set of
    the remaining indices on hop matrices full of ties, +inf included."""
    rng = np.random.default_rng(0)
    for n in (5, 17, 64, 130):
        sub = rng.integers(0, 3, size=(n, n)).astype(np.float32)
        sub[rng.random((n, n)) < 0.2] = np.inf
        start = int(rng.integers(n))
        remaining = set(range(n))
        seq = [start]
        remaining.discard(start)
        while remaining:
            cur = seq[-1]
            nxt = min(remaining, key=lambda j: sub[cur, j])
            seq.append(nxt)
            remaining.discard(nxt)
        assert port_embedding._nearest_neighbor(sub, start) == seq


def test_two_opt_and_tour_length_equal_reference():
    from repro.fabric import embedding as ref_embedding

    p, r = _fabrics(n_pods=48, degree=5, seed=2)
    dist = ref_apsp_hops(r.topology.adjacency())
    order = np.random.default_rng(1).permutation(48)
    for seed in (0, 7):
        got = port_embedding._two_opt(order, dist, seed=seed)
        np.testing.assert_array_equal(
            got, ref_embedding._two_opt(order, dist, seed=seed))
        assert port_embedding._tour_length(got, dist) == \
            ref_embedding._tour_length(got, dist)


# --------------------------------------------------------------------------- #
# the hop matrix
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["jellyfish", "failed", "islands"])
def test_device_path_hop_matrix_equals_apsp_hops(case):
    """``hops_to_f32`` of the int16 APSP (what the embedding reads) equals
    the reference's float ``apsp_hops``, unreachable pairs included; the
    blocked min-plus APSP's int16 form (the card's path, here through its
    plain version) gives the same matrix."""
    if case == "islands":
        edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 4)]
        pt = TC.Topology.regular(7, 3, 2, edges)
    else:
        pt = TC.jellyfish(120, 9, 8, seed=5)
        if case == "failed":
            pt = TC.fail_links(pt, 0.3, seed=2)
    adj = pt.adjacency()
    want = ref_apsp_hops(adj)
    port_routing.clear_routing_cache()
    got = port_embedding._hops(pt, CPU_DEV)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    d16 = ops.apsp_minplus_blocked(adj, device=CPU)
    assert d16.dtype == np.int16
    np.testing.assert_array_equal(hops_to_f32(d16), want)


# --------------------------------------------------------------------------- #
# collective cost models
# --------------------------------------------------------------------------- #

_COSTS = ["ring_all_reduce", "ring_reduce_scatter", "ring_all_gather",
          "all_to_all", "tree_all_reduce"]


@pytest.mark.parametrize("n", [1, 2, 16, 1000])
@pytest.mark.parametrize("size", [0, 12345, 1 << 30])
@pytest.mark.parametrize("kind", _COSTS)
def test_collective_costs_bit_equal(kind, size, n):
    for bw, lat, eff in ((50e9, 1e-6, 1.0), (12.5e9, 3e-6, 0.37)):
        cp = getattr(T, kind)(size, n, T.LinkSpec(bw, lat, eff))
        cr = getattr(R, kind)(size, n, R.LinkSpec(bw, lat, eff))
        assert (cp.time, cp.wire_bytes_per_device, cp.steps) == (
            cr.time, cr.wire_bytes_per_device, cr.steps)
    s = getattr(T, kind)(size, n, T.LinkSpec()) + T.ring_all_reduce(
        size, n, T.LinkSpec())
    t = getattr(R, kind)(size, n, R.LinkSpec()) + R.ring_all_reduce(
        size, n, R.LinkSpec())
    assert (s.time, s.wire_bytes_per_device, s.steps) == (
        t.time, t.wire_bytes_per_device, t.steps)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute", "bogus"])
def test_bytes_on_wire_bit_equal(kind):
    for size, n in ((100, 2), (160, 16), (7, 99), (100, 1), (1 << 33, 4096)):
        try:
            want = R.bytes_on_wire(kind, size, n)
        except ValueError:
            with pytest.raises(ValueError):
                T.bytes_on_wire(kind, size, n)
            continue
        assert T.bytes_on_wire(kind, size, n) == want


def test_link_spec_defaults_match_reference():
    assert (T.LinkSpec().bandwidth, T.LinkSpec().latency,
            T.LinkSpec().efficiency) == (R.LinkSpec().bandwidth,
                                         R.LinkSpec().latency,
                                         R.LinkSpec().efficiency)
    assert T.LinkSpec(efficiency=0.5).effective_bw == \
        R.LinkSpec(efficiency=0.5).effective_bw
    assert sorted(T.__all__) == sorted(R.__all__)


# --------------------------------------------------------------------------- #
# the elastic delta chain
# --------------------------------------------------------------------------- #


def _remap(comm, remap, cls):
    nm = np.asarray(remap)
    keep = (nm[comm.src] >= 0) & (nm[comm.dst] >= 0)
    return cls(src=nm[comm.src[keep]], dst=nm[comm.dst[keep]],
               demand=comm.demand[keep], n_flows=int(keep.sum()))


def test_fabric_model_delta_chain_equals_reference_and_rebuild():
    """``path_system`` -> ``fail`` -> ``expand`` -> ``remove``: every port
    path system equals the reference chain's (``row_map`` included) and the
    port's rebuild; each step is a delta, not a fallback rebuild."""
    p, r = _fabrics(n_pods=64, degree=6, seed=0)
    cp = TC.random_permutation_traffic(p.topology, seed=0)
    cr = RC.random_permutation_traffic(r.topology, seed=0)
    np.testing.assert_array_equal(cp.src, cr.src)
    ps_p, ps_r = p.path_system(cp, k=4), r.path_system(cr, k=4)
    assert ps_p.row_map is None
    _same_system(ps_p, ps_r)
    steps = [("fail", (0.1,), 1), ("expand", (4,), 2), ("remove", (7,), 3)]
    for what, args, seed in steps:
        p = getattr(p, what)(*args, seed=seed)
        r = getattr(r, what)(*args, seed=seed)
        assert p.device == CPU_DEV and p._parent is not None
        assert TC.edge_fingerprint(p.topology) == \
            RC.edge_fingerprint(r.topology)
        if what == "remove":
            cp = _remap(cp, p.topology.meta["node_remap"], Commodities)
            cr = _remap(cr, r.topology.meta["node_remap"], type(cr))
        ps_p, ps_r = p.path_system(cp, k=4), r.path_system(cr, k=4)
        assert p._parent is None and p._ps is ps_p
        assert ps_p.row_map is not None and (ps_p.row_map >= 0).any(), what
        _same_system(ps_p, ps_r)
        np.testing.assert_array_equal(ps_p.row_map, ps_r.row_map)
        full = TC.build_path_system(p.topology, cp, k=4, cache=False,
                                    device=CPU)
        _same_system(ps_p, full)


def test_entry_points_default_to_the_card():
    for fn in (T.embed_ring, T.all_to_all_congestion, T.make_fabric):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert T.FabricModel.__dataclass_fields__["device"].default == "cuda"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA: checks the entry points raise there")
def test_entry_points_raise_without_a_card():
    top = TC.jellyfish(16, 5, 4, seed=0)
    for call in (lambda: T.make_fabric("jellyfish", n_pods=16),
                 lambda: T.FabricModel(top, T.LinkSpec()),
                 lambda: T.embed_ring(top),
                 lambda: T.all_to_all_congestion(top)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# --------------------------------------------------------------------------- #
# the reference's tests/test_fabric.py, on the port
# --------------------------------------------------------------------------- #


def test_ring_embedding_covers_all_members_once():
    top = TC.jellyfish(32, 8, 5, seed=0)
    emb = T.embed_ring(top, device=CPU)
    assert sorted(emb.order.tolist()) == list(range(32))
    assert emb.stretch >= 1.0
    assert emb.congestion >= 1.0
    nbrs = top.adjacency_sets()
    for p in emb.hop_paths:
        for a, b in zip(p, p[1:]):
            assert b in nbrs[a]


def test_jellyfish_ring_beats_fattree_stretch():
    """The paper's low-diameter claim shows up as lower ring stretch."""
    jf = T.make_fabric("jellyfish", n_pods=64, degree=6, seed=1, device=CPU)
    ft = T.make_fabric("fattree", n_pods=64, device=CPU)
    assert jf.ring().stretch <= ft.ring().stretch + 0.05


def test_fabric_expand_and_fail_keep_ring_embeddable():
    fb = T.make_fabric("jellyfish", n_pods=32, degree=5, seed=2, device=CPU)
    grown = fb.expand(8, seed=3)
    assert grown.topology.n_switches == 40
    assert grown.ring().congestion < 10
    degraded = fb.fail(0.15, seed=4)
    emb = degraded.ring()
    assert emb.stretch < 3.0  # still a usable fabric


def test_collective_cost_models_sane():
    link = T.LinkSpec(bandwidth=50e9, latency=1e-6)
    n, size = 16, 1 << 30
    ar = T.ring_all_reduce(size, n, link)
    rs = T.ring_reduce_scatter(size, n, link)
    ag = T.ring_all_gather(size, n, link)
    a2a = T.all_to_all(size, n, link)
    tr = T.tree_all_reduce(size, n, link)
    assert ar.wire_bytes_per_device == pytest.approx(
        rs.wire_bytes_per_device + ag.wire_bytes_per_device
    )
    assert ar.time > max(rs.time, ag.time)
    assert a2a.wire_bytes_per_device < ar.wire_bytes_per_device
    assert tr.steps < ar.steps
    half = T.LinkSpec(bandwidth=50e9, latency=1e-6, efficiency=0.5)
    assert T.ring_all_reduce(size, n, half).time > ar.time * 1.9


def test_bytes_on_wire_models():
    assert T.bytes_on_wire("all-reduce", 100, 2) == pytest.approx(100.0)
    assert T.bytes_on_wire("all-gather", 160, 16) == pytest.approx(150.0)
    assert T.bytes_on_wire("collective-permute", 7, 99) == 7
    assert T.bytes_on_wire("all-reduce", 100, 1) == 0.0
    with pytest.raises(ValueError):
        T.bytes_on_wire("bogus", 1, 2)


def test_fabric_a2a_efficiency_in_unit_range():
    fb = T.make_fabric("jellyfish", n_pods=24, degree=6, seed=5, device=CPU)
    e = fb.a2a_efficiency()
    assert 0 < e <= 1.0


def test_fabric_path_system_uses_delta_chain():
    fabric = T.make_fabric("jellyfish", n_pods=32, degree=6, seed=0,
                           device=CPU)
    comm = TC.random_permutation_traffic(fabric.topology, seed=0)
    ps = fabric.path_system(comm)
    assert ps.row_map is None  # first build
    f2 = fabric.fail(0.05, seed=1)
    ps2 = f2.path_system(comm)
    assert ps2.row_map is not None and (ps2.row_map >= 0).any()
    full = TC.build_path_system(f2.topology, comm, cache=False, device=CPU)
    _same_system(ps2, full)
