"""The batch path-system build, ECMP, the DFS and the build pipeline:
port against reference, on the CPU.

Everything here is exact (the enumerator is numpy carried over with the
same calls and tie order):

* ``build_path_system_batch`` equals the port's own sequential builds and
  the reference's batch byte for byte (path slots, lengths, owners,
  demands, pedigree, row order), for B = 1, reversed and self pairs,
  duplicated and ragged topologies, and any shard size
  (``REPRO_ROUTE_TILE_BYTES``); its envelope is ``from_systems``'s.
* ``ecmp_path_system`` equals the reference's, on a Jellyfish and on a
  fat-tree, where its groups are the analytic ``(k/2)^2`` / ``k/2``.
* The historical DFS equals the reference's.
* ``stream_builds`` yields in submission order, prefetches one ahead, runs
  inline when off and raises a failed build at its own position; the
  capacity search gives the same server count with the pipeline on and
  off (and the reference's).
* ``check_built_batch`` (CT-build) accepts a fresh batch and rejects a
  broken one.
"""

import dataclasses
import threading

import numpy as np
import pytest

import repro.core as R
from benchmarks.common import jellyfish_same_equipment as ref_same_equipment
from benchmarks.common import max_servers_at_full_capacity as ref_max_servers
from repro.core import routing as ref_routing
import repro_torch.core as T
from repro_torch import capacity, env
from repro_torch.analysis.contracts import ContractViolation, check_built_batch
from repro_torch.core import routing as port_routing
from repro_torch.core.flow import PathSystemBatch
from repro_torch.sim import ecmp_group_sizes, fattree_ecmp_check

CPU = "cpu"
FIELDS = ("path_edges", "path_len", "path_owner", "demands", "src", "dst",
          "unrouted")


def _mixed(pkg):
    """Ragged sizes, a duplicated topology, distinct traffic per slot."""
    specs = [(20, 6, 4, 0), (20, 6, 4, 0), (26, 7, 5, 1), (14, 5, 3, 2)]
    tops = [pkg.jellyfish(n, k, r, seed=s) for n, k, r, s in specs]
    comms = [pkg.random_permutation_traffic(t, seed=100 + i)
             for i, t in enumerate(tops)]
    return tops, comms


def _assert_ps_equal(a, b, ctx=""):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f"{ctx}: {f}"
    assert a.n_edges == b.n_edges, ctx
    assert a.n_commodities == b.n_commodities, ctx
    assert (a.row_map is None) == (b.row_map is None), ctx


def test_batch_equals_sequential_and_reference():
    tops, comms = _mixed(T)
    seq = [T.build_path_system(t, c, k=4, max_slack=2, device=CPU)
           for t, c in zip(tops, comms)]
    port_routing.clear_routing_cache()
    batch = T.build_path_system_batch(tops, comms, k=4, max_slack=2,
                                      device=CPU)
    rtops, rcomms = _mixed(R)
    ref = R.build_path_system_batch(rtops, rcomms, k=4, max_slack=2)
    assert len(batch.systems) == len(seq) == len(ref.systems)
    for i, (a, b, c) in enumerate(zip(seq, batch.systems, ref.systems)):
        _assert_ps_equal(a, b, f"sequential {i}")
        _assert_ps_equal(c, b, f"reference {i}")
    for f in ("path_edges", "path_owner", "demands", "inv_cap", "slot_valid",
              "n_paths"):
        assert np.array_equal(getattr(batch, f),
                              np.asarray(getattr(ref, f))), f


def test_batch_b1_degenerate():
    top = T.jellyfish(18, 6, 4, seed=7)
    comm = T.random_permutation_traffic(top, seed=3)
    a = T.build_path_system(top, comm, k=4, max_slack=2, device=CPU)
    b = T.build_path_system_batch([top], [comm], k=4, max_slack=2,
                                  device=CPU).systems[0]
    _assert_ps_equal(a, b, "B=1")


def test_batch_reversed_and_self_pairs():
    top = T.jellyfish(16, 6, 4, seed=4)
    perm = T.random_server_permutation(int(top.servers_per_switch.sum()),
                                       seed=11)
    comm = T.permutation_commodities(top, perm)
    # a self pair (src == dst) rides along as an extra commodity
    comm = dataclasses.replace(
        comm, src=np.r_[comm.src, 3], dst=np.r_[comm.dst, 3],
        demand=np.r_[comm.demand, 1.0])
    assert np.any(comm.src > comm.dst)
    a = T.build_path_system(top, comm, k=4, max_slack=2, device=CPU)
    b = T.build_path_system_batch([top, top], [comm, comm], k=4, max_slack=2,
                                  device=CPU).systems[1]
    _assert_ps_equal(a, b, "reversed and self pairs")
    assert a.path_len[a.path_owner == a.n_commodities - 1].tolist() == [0]


@pytest.mark.parametrize("tile_bytes", [1 << 20, 1 << 22])
def test_batch_shard_size_invariance(monkeypatch, tile_bytes):
    tops, comms = _mixed(T)
    base = T.build_path_system_batch(tops, comms, k=4, max_slack=2,
                                     cache=False, device=CPU)
    monkeypatch.setattr(port_routing, "_FRONTIER_TILE_BYTES", tile_bytes)
    small = T.build_path_system_batch(tops, comms, k=4, max_slack=2,
                                      cache=False, device=CPU)
    for i, (a, b) in enumerate(zip(base.systems, small.systems)):
        _assert_ps_equal(a, b, f"tile budget {tile_bytes}, instance {i}")


def test_shard_by_dst_cuts_at_block_boundaries():
    dst = np.array([9, 1, 5, 12, 3, 7, 14, 0])
    sel = np.arange(len(dst))
    blocks = np.array([0, 6, 10])
    want = ref_routing._shard_by_dst(sel, dst, 3, 256, blocks)
    got = port_routing._shard_by_dst(sel, dst, 3, 256, blocks)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    for sh in got:  # every shard's destinations in ONE block
        assert len(np.unique(np.searchsorted(blocks, dst[sh], "right"))) == 1


def test_batch_envelope_matches_from_systems():
    tops, comms = _mixed(T)
    batch = T.build_path_system_batch(tops, comms, k=4, max_slack=2,
                                      device=CPU)
    rebuilt = PathSystemBatch.from_systems(list(batch.systems))
    for f in ("path_edges", "path_owner", "demands", "inv_cap", "slot_valid",
              "n_paths", "slot_gather", "owner_gather"):
        assert np.array_equal(getattr(batch, f), getattr(rebuilt, f)), f


def test_batch_rejects_mismatched_lengths():
    tops, comms = _mixed(T)
    with pytest.raises(ValueError):
        T.build_path_system_batch(tops, comms[:-1], k=4, device=CPU)
    with pytest.raises(ValueError):
        T.build_path_system_batch([], [], k=4, device=CPU)


def test_check_built_batch_accepts_and_rejects():
    tops, comms = _mixed(T)
    batch = T.build_path_system_batch(tops, comms, k=4, max_slack=2,
                                      device=CPU)
    check_built_batch(batch, tops)
    bad = batch.path_edges.copy()
    bad[0, int(batch.n_paths[0]):, :] = 0  # clobber the padding sentinel
    broken = dataclasses.replace(batch, path_edges=bad)
    with pytest.raises(ContractViolation):
        check_built_batch(broken, tops)


# --------------------------------------------------------------------------- #
# ECMP and the DFS
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,ports,net,seed,ways", [(72, 12, 8, 5, 64),
                                                   (48, 10, 6, 2, 16)])
def test_ecmp_equals_reference(n, ports, net, seed, ways):
    rt = R.jellyfish(n, ports, net, seed=seed)
    pt = T.jellyfish(n, ports, net, seed=seed)
    rc = R.random_permutation_traffic(rt, seed=seed + 1)
    pc = T.random_permutation_traffic(pt, seed=seed + 1)
    ref = R.ecmp_path_system(rt, rc, n_ways=ways)
    got = T.ecmp_path_system(pt, pc, n_ways=ways, device=CPU)
    _assert_ps_equal(ref, got, "ecmp")
    assert got.max_slack == 0 and got.k == ways
    with pytest.raises(ValueError):
        T.ecmp_path_system(pt, pc, n_ways=0, device=CPU)


def test_ecmp_identical_across_shards(monkeypatch):
    top = T.jellyfish(72, 12, 8, seed=7)
    comm = T.random_permutation_traffic(top, seed=8)
    base = T.ecmp_path_system(top, comm, cache=False, device=CPU)
    monkeypatch.setattr(port_routing, "_FRONTIER_TILE_BYTES", 1 << 12)
    sharded = T.ecmp_path_system(top, comm, cache=False, device=CPU)
    _assert_ps_equal(base, sharded, "sharded ecmp")


@pytest.mark.parametrize("k", [4, 6])
def test_ecmp_fattree_analytic_groups(k):
    ft = T.fattree(k)
    comm = T.random_permutation_traffic(ft, seed=0)
    eps = T.ecmp_path_system(ft, comm, n_ways=64, device=CPU)
    ref = R.ecmp_path_system(R.fattree(k),
                             R.random_permutation_traffic(R.fattree(k),
                                                          seed=0), n_ways=64)
    _assert_ps_equal(ref, eps, f"fat-tree k={k}")
    chk = fattree_ecmp_check(eps, k)
    assert chk["inter_pod_groups_exact"] and chk["same_pod_groups_exact"]
    assert chk["expected_inter_pod"] == (k // 2) ** 2
    groups = ecmp_group_sizes(eps)
    assert groups.sum() == eps.n_paths


def test_dfs_equals_reference():
    rt = R.jellyfish(24, 8, 5, seed=3)
    pt = T.jellyfish(24, 8, 5, seed=3)
    rng = np.random.default_rng(0)
    pairs = [tuple(map(int, p)) for p in rng.integers(0, 24, (20, 2))]
    for k, slack in ((4, 2), (8, 3)):
        want = ref_routing._k_shortest_paths_dfs(rt, pairs, k=k,
                                                 max_slack=slack)
        got = port_routing._k_shortest_paths_dfs(pt, pairs, k=k,
                                                 max_slack=slack)
        assert got == want
        # the DFS finds the batched enumerator's path lengths
        fast = T.k_shortest_paths(pt, pairs, k=k, max_slack=slack,
                                  device=CPU)
        assert [[len(p) for p in ps] for ps in got] == \
            [[len(p) for p in ps] for ps in fast]


# --------------------------------------------------------------------------- #
# stream_builds
# --------------------------------------------------------------------------- #


def test_stream_builds_order_and_results():
    log = []

    def thunk_of(i):
        def thunk():
            log.append(i)
            return i * i
        return thunk

    assert list(T.stream_builds([thunk_of(i) for i in range(5)],
                                enabled=True)) == [0, 1, 4, 9, 16]
    assert log == [0, 1, 2, 3, 4]  # single worker, submission order


def test_stream_builds_prefetches_one_ahead():
    started = threading.Event()
    release = threading.Event()

    def second():
        started.set()
        release.wait(timeout=10)
        return 1

    it = T.stream_builds([lambda: 0, second], enabled=True)
    assert next(it) == 0
    assert started.wait(timeout=10), "build 1 did not overlap consumption"
    release.set()
    assert next(it) == 1


def test_stream_builds_disabled_runs_inline():
    tid = []

    def thunk():
        tid.append(threading.get_ident())
        return 42

    assert list(T.stream_builds([thunk], enabled=False)) == [42]
    assert tid == [threading.get_ident()]


def test_stream_builds_errors_at_their_position():
    def boom():
        raise RuntimeError("build failed")

    it = T.stream_builds([lambda: 1, boom], enabled=True)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="build failed"):
        next(it)


def test_set_build_pipeline_round_trip_and_env(monkeypatch):
    prev = T.set_build_pipeline(False)
    try:
        assert T.pipeline_enabled() is False
        assert T.pipeline_enabled(True) is True  # explicit arg wins
        T.set_build_pipeline(True)
        assert T.pipeline_enabled() is True
    finally:
        T.set_build_pipeline(prev)
    monkeypatch.delenv("REPRO_BUILD_PIPELINE", raising=False)
    assert env.read("REPRO_BUILD_PIPELINE") is True
    monkeypatch.setenv("REPRO_BUILD_PIPELINE", "0")
    assert env.read("REPRO_BUILD_PIPELINE") is False
    monkeypatch.setenv("REPRO_BUILD_PIPELINE", "yes")
    with pytest.raises(ValueError, match="REPRO_BUILD_PIPELINE"):
        env.read("REPRO_BUILD_PIPELINE")


@pytest.mark.parametrize("k,wave", [(4, 1), (4, 2), (6, 1)])
def test_capacity_same_with_pipeline_on_and_off(k, wave):
    eq = T.fattree_equipment(k)
    args = dict(lo=eq["servers"] // 2, hi=2 * eq["servers"], seeds=(0, 1),
                wave_levels=wave)
    got = {}
    prev = T.set_build_pipeline(True)
    try:
        for flag in (True, False):
            T.set_build_pipeline(flag)
            port_routing.clear_routing_cache()
            got[flag] = capacity.max_servers_at_full_capacity(
                eq["switches"], eq["ports_per_switch"], device=CPU, **args)
    finally:
        T.set_build_pipeline(prev)
    assert got[True] == got[False]
    assert got[True] == ref_max_servers(eq["switches"],
                                        eq["ports_per_switch"], **args)


def test_probe_systems_same_with_pipeline_on_and_off():
    top = capacity.jellyfish_same_equipment(20, 8, 60, seed=0)
    prev = T.set_build_pipeline(True)
    try:
        on = list(capacity._probe_systems(top, 3, 8, CPU))
        T.set_build_pipeline(False)
        off = list(capacity._probe_systems(top, 3, 8, CPU))
    finally:
        T.set_build_pipeline(prev)
    for i, (a, b) in enumerate(zip(on, off)):
        _assert_ps_equal(a, b, f"probe matrix {i}")
    rtop = ref_same_equipment(20, 8, 60, seed=0)
    rps = R.build_path_system(rtop, R.random_permutation_traffic(rtop, seed=2),
                              k=8, max_slack=3)
    _assert_ps_equal(rps, on[2], "reference matrix 2")
