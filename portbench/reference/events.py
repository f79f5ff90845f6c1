"""A plain reference of live topology events in the flow-level simulator
(paper §4.2-§4.3 under §5's simulator): the benchmark's reference for the
event cells.

The rules the program states for ``sim.events.simulate_events``, written
from their definition, per instance, for a boundary whose events change the
topology:

1. **Which rows survive.**  Each event's delta routing keeps a commodity's
   rows, in their order, when none of them crosses a removed link, its
   endpoints' hop distance is unchanged, and every path through an added
   link is longer than the commodity's budget (its longest path where it
   has ``k``, else its distance plus the slack); every other commodity is
   enumerated afresh, and a delta that changes more than a quarter of the
   new topology's links is a rebuild, which keeps no row
   (``update_path_system``'s stated rule).  A row survives a boundary when
   every event of the boundary keeps it.
2. **Survivors** keep ``rem``, ``age``, ``fid`` and ``hold`` bit for bit
   and follow their row to its new index.
3. **Disrupted flows** whose commodity still has routes re-select: the
   first of the commodity's candidate rows, in table order, whose largest
   relative link load under the migrated loads is least.  A flow whose old
   path lost a link (a hop with no image in the new topology) takes
   ``hold = lag``; any other keeps its ``hold``.
4. **Killed flows** (a commodity left without routes) free their slot;
   their remainders, summed in float64 and added to the instance's total,
   are blackholed.
5. **Link state** (last step's relative loads, the utilisation sums)
   follows each link to its new slot; a new link starts at zero.

Between boundaries the step loop is ``reference/sim.py``'s, with held
flows: a flow whose ``hold`` is positive takes no capacity and delivers
nothing; it drains ``min(rem, bh_rate * dt)`` into the blackhole, ages,
and frees its slot when drained, with no completion time; each step ends
with every ``hold`` one lower.

Arrivals are given per segment as the program's callable received them:
commodity indices among the segment's routed commodities, ascending by
global id.  It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import paths
from portbench.reference.frozen import expansion as fexp
from portbench.reference.frozen import failures as ffail
from portbench.reference.sim import DONE_ABS, TIE_REL, _loads_fn, _waterfill

__all__ = ["Boundary", "event_chain", "kept_rows", "migrate", "run_segment",
           "simulate_with_events", "slot_map"]

#: A delta that changes more than this share of the new links is a rebuild.
REBUILD_FRACTION = 0.25


def _keys(edges: np.ndarray, n: int) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return e[:, 0] * n + e[:, 1]


def _edge_ids(edges: np.ndarray, within: np.ndarray, n: int) -> np.ndarray:
    """Row of each edge of ``edges`` in ``within``, or -1."""
    a, b = _keys(edges, n), _keys(within, n)
    if not len(b):
        return np.full(len(a), -1, dtype=np.int64)
    order = np.argsort(b, kind="stable")
    pos = np.minimum(np.searchsorted(b[order], a), len(b) - 1)
    return np.where(b[order][pos] == a, order[pos], -1)


def slot_map(old_edges, new_edges, n: int) -> np.ndarray:
    """(2 E_old,) each old directed slot's slot in the new topology, or -1
    where its link is gone (``n`` bounds both topologies' switch ids)."""
    E_o, E_n = len(old_edges), len(new_edges)
    eid = _edge_ids(old_edges, new_edges, n)
    sm = np.full(2 * E_o, -1, dtype=np.int64)
    ok = eid >= 0
    sm[:E_o][ok] = eid[ok]
    sm[E_o:][ok] = eid[ok] + E_n
    return sm


def kept(routes) -> np.ndarray:
    """Global ids of a table's routed commodities, ascending."""
    return np.flatnonzero(~np.asarray(routes.unrouted))


def kept_rows(old, new, old_top, new_top, src, dst, k: int,
              max_slack: int) -> np.ndarray:
    """(P_new,) each new row's row in ``old``, or -1 where the row is fresh
    (rule 1, one event)."""
    P_new = new.n_paths
    out = np.full(P_new, -1, dtype=np.int64)
    n = max(old_top.n_switches, new_top.n_switches)
    E_o, E_n = old_top.n_edges, new_top.n_edges
    added = new_top.edges[_edge_ids(new_top.edges, old_top.edges, n) < 0]
    removed = _edge_ids(old_top.edges, new_top.edges, n) < 0
    if len(added) + int(removed.sum()) > REBUILD_FRACTION * max(E_n, 1):
        return out
    d_old = paths.hop_distances(old_top.n_switches, old_top.edges)
    d_new = paths.hop_distances(new_top.n_switches, new_top.edges)
    ko, kn = kept(old), kept(new)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # per routed old commodity: its rows, whether one crosses a removed
    # link, their count and longest length
    owner = np.asarray(old.path_owner)
    pe = np.asarray(old.path_edges)
    real = pe < 2 * E_o
    hit = real & removed[np.where(real, pe % max(E_o, 1), 0)]
    broken = np.zeros(len(ko), dtype=bool)
    np.logical_or.at(broken, owner, hit.any(axis=1))
    cnt = np.bincount(owner, minlength=len(ko))
    maxlen = np.zeros(len(ko), dtype=np.int64)
    np.maximum.at(maxlen, owner, np.asarray(old.path_len, dtype=np.int64))
    s, t = src[ko], dst[ko]
    same = d_old[s, t] == d_new[s, t]
    if len(added):
        au, av = added[:, 0], added[:, 1]
        via = np.minimum(d_new[s[:, None], au] + d_new[t[:, None], av],
                         d_new[s[:, None], av] + d_new[t[:, None], au]
                         ).min(axis=1) + 1.0
    else:
        via = np.full(len(ko), np.inf)
    budget = np.where(cnt >= k, maxlen.astype(np.float64),
                      d_new[s, t] + max_slack)
    reuse = ~broken & same & (via > budget)
    # a reused commodity's new rows are its old rows, in order
    new_owner = np.asarray(new.path_owner)
    old_first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    new_cnt = np.bincount(new_owner, minlength=len(kn))
    new_first = np.concatenate([[0], np.cumsum(new_cnt)[:-1]])
    old_pos = {int(g): c for c, g in enumerate(ko)}
    for cn, g in enumerate(kn):
        co = old_pos.get(int(g))
        if co is None or not reuse[co]:
            continue
        m = int(cnt[co])
        out[new_first[cn]: new_first[cn] + m] = (old_first[co]
                                                 + np.arange(m))
    return out


@dataclasses.dataclass
class Boundary:
    """One boundary's events applied to every instance."""

    step: int
    kinds: list  # the events' kinds, in schedule order
    tops: list  # per instance, after each event: [event][instance]
    routes: list  # per instance, after each event: [event][instance]
    row_map: list  # per instance: new row -> row before the boundary, or -1
    slot_map: list  # per instance: slot before the boundary -> new, or -1


def _producer(ev: dict, top, instance: int, heal_store: dict):
    rng = np.random.default_rng([int(ev.get("seed", 0)), int(instance)])
    kind = ev["kind"]
    if kind == "fail_links":
        if ev.get("n_links") is not None:
            new = ffail.fail_links(top, seed=rng, n_links=int(ev["n_links"]))
        else:
            new = ffail.fail_links(top, fraction=float(ev["fraction"]),
                                   seed=rng)
        if ev.get("tag") is not None:
            heal_store[(ev["tag"], instance)] = list(
                new.meta["edges_removed"])
        return new
    if kind == "heal_links":
        return ffail.heal_links(top, heal_store.pop((ev["heal_of"], instance)))
    if kind == "expand":
        return fexp.expand_to(top, top.n_switches + int(ev["grow"]), seed=rng)
    raise ValueError(f"no reference for event kind {kind!r}")


def event_chain(tops, comms, schedule, k: int, max_slack: int,
                routes0=None) -> list:
    """The :class:`Boundary` of each event step of ``schedule`` (dicts
    with ``step``, ``kind`` and the producer's parameters, applied in
    schedule order within a step), from the topologies ``tops`` and their
    commodities ``comms``; ``routes0`` are the tables of ``tops`` where
    already built.  Randomized producers draw from
    ``default_rng([seed, instance])``."""
    B = len(tops)
    memo: dict = {}

    def tables(top, comm):
        key = (top.n_switches, _keys(top.edges, top.n_switches).tobytes(),
               id(comm))
        if key not in memo:
            memo[key] = paths.route_tables(top.n_switches, top.edges,
                                           comm.src, comm.dst, comm.demand,
                                           k, max_slack)
        return memo[key]

    if routes0 is not None:
        for t, c, r in zip(tops, comms, routes0):
            memo[(t.n_switches, _keys(t.edges, t.n_switches).tobytes(),
                  id(c))] = r
    cur_t = list(tops)
    cur_r = [tables(t, c) for t, c in zip(tops, comms)]
    heal_store: dict = {}
    steps = sorted({int(e["step"]) for e in schedule})
    out = []
    for step in steps:
        evs = [e for e in schedule if int(e["step"]) == step]
        rm = [np.arange(r.n_paths, dtype=np.int64) for r in cur_r]
        sm = [np.arange(r.n_slots, dtype=np.int64) for r in cur_r]
        b = Boundary(step, [e["kind"] for e in evs], [], [], rm, sm)
        for ev in evs:
            for i in range(B):
                new_t = _producer(ev, cur_t[i], i, heal_store)
                new_r = tables(new_t, comms[i])
                rows = kept_rows(cur_r[i], new_r, cur_t[i], new_t,
                                 comms[i].src, comms[i].dst, k, max_slack)
                ok = rows >= 0
                nt = np.full(len(rows), -1, dtype=np.int64)
                nt[ok] = rm[i][rows[ok]]
                rm[i] = nt
                n = max(cur_t[i].n_switches, new_t.n_switches)
                step_sm = slot_map(cur_t[i].edges, new_t.edges, n)
                st = np.full(len(sm[i]), -1, dtype=np.int64)
                ok = sm[i] >= 0
                st[ok] = step_sm[sm[i][ok]]
                sm[i] = st
                cur_t[i], cur_r[i] = new_t, new_r
            b.tops.append(list(cur_t))
            b.routes.append(list(cur_r))
        out.append(b)
    return out


def migrate(state: dict, old_routes, new_routes, row_map, slot_maps,
            lag: int) -> tuple[dict, dict]:
    """Rules 2-5 over one boundary for every instance.

    ``state`` holds ``row`` (B, F), -1 for an empty slot, ``rem``, ``age``
    (B, F), ``fid``, ``hold`` (B, F), ``bh`` (B,), and per instance ``rel``
    and ``util`` (each of the instance's 2E slots).  Float arrays keep
    their dtype.  Returns the new state and, per instance, the slots of the
    ``survived``, ``reselected`` and ``killed`` flows and ``near_tie``,
    whether each reselection had another candidate within ``TIE_REL``."""
    row, rem, age = state["row"], state["rem"], state["age"]
    fid, hold, bh = state["fid"], state["hold"], state["bh"]
    B = row.shape[0]
    new = {"row": np.full_like(row, -1), "rem": np.zeros_like(rem),
           "age": np.zeros_like(age), "fid": np.zeros_like(fid),
           "hold": np.zeros_like(hold), "bh": bh.copy(), "rel": [],
           "util": []}
    sets = {"survived": [], "reselected": [], "killed": [], "near_tie": []}
    for i in range(B):
        old, nr, sm, rm = old_routes[i], new_routes[i], slot_maps[i], row_map[i]
        rel = np.asarray(state["rel"][i])
        rel_new = np.zeros(nr.n_slots, dtype=rel.dtype)
        util_new = np.zeros(nr.n_slots, dtype=rel.dtype)
        ok = sm >= 0
        rel_new[sm[ok]] = rel[ok]
        util_new[sm[ok]] = np.asarray(state["util"][i])[ok]
        new["rel"].append(rel_new)
        new["util"].append(util_new)
        fwd = np.full(old.n_paths, -1, dtype=np.int64)
        fwd[rm[rm >= 0]] = np.flatnonzero(rm >= 0)
        act = np.flatnonzero(row[i] >= 0)
        r_old = row[i, act]
        sv = fwd[r_old] >= 0
        s_idx, d_idx = act[sv], act[~sv]
        new["row"][i, s_idx] = fwd[r_old[sv]]
        for f in ("rem", "age", "fid", "hold"):
            new[f][i, s_idx] = state[f][i, s_idx]
        ko, kn = kept(old), kept(nr)
        g = ko[np.asarray(old.path_owner)[row[i, d_idx]]]
        pos = np.searchsorted(kn, g)
        routed = (pos < len(kn)) & (kn[np.minimum(pos, max(len(kn) - 1, 0))]
                                    == g) if len(kn) else np.zeros(len(g), bool)
        k_idx, r_idx = d_idx[~routed], d_idx[routed]
        if k_idx.size:
            new["bh"][i] = (bh[i] + np.asarray(rem[i, k_idx], np.float64).sum()
                            ).astype(bh.dtype)
        ties = np.zeros(len(r_idx), dtype=bool)
        if r_idx.size:
            pe_o = np.asarray(old.path_edges)[row[i, r_idx]]
            real = pe_o < old.n_slots
            dead = (real & (sm[np.where(real, pe_o, 0)] < 0)).any(axis=1)
            n_cand = np.bincount(np.asarray(nr.path_owner),
                                 minlength=len(kn))
            first = np.concatenate([[0], np.cumsum(n_cand)[:-1]])
            pe_n = np.asarray(nr.path_edges)
            relp = np.concatenate([rel_new, np.zeros(1, dtype=rel_new.dtype)])
            for t, (flow, c) in enumerate(zip(r_idx, pos[routed])):
                cand = first[c] + np.arange(n_cand[c])
                hops = pe_n[cand]
                u_h = relp[np.minimum(hops, nr.n_slots)]
                util = u_h.max(axis=1)
                j = int(np.argmin(util))
                best = util[j]
                bott = hops[np.arange(len(cand)), u_h.argmax(axis=1)]
                near = util <= best * (1 + TIE_REL) + 1e-12
                same = (util == best) & ((best == 0) | (bott == bott[j]))
                ties[t] = bool((near & ~same).any())
                new["row"][i, flow] = cand[j]
            for f in ("rem", "age", "fid"):
                new[f][i, r_idx] = state[f][i, r_idx]
            new["hold"][i, r_idx] = np.where(dead, lag, hold[i, r_idx])
        sets["survived"].append(s_idx)
        sets["reselected"].append(r_idx)
        sets["killed"].append(k_idx)
        sets["near_tie"].append(ties)
    return new, sets


def empty_state(routes, n_flows: int, dtype=np.float64) -> dict:
    B = len(routes)
    return {"row": np.full((B, n_flows), -1, dtype=np.int64),
            "rem": np.zeros((B, n_flows), dtype=dtype),
            "age": np.zeros((B, n_flows), dtype=dtype),
            "fid": np.zeros((B, n_flows), dtype=np.int64),
            "hold": np.zeros((B, n_flows), dtype=np.int64),
            "bh": np.zeros(B, dtype=dtype),
            "rel": [np.zeros(r.n_slots, dtype=dtype) for r in routes],
            "util": [np.zeros(r.n_slots, dtype=dtype) for r in routes]}


def run_segment(routes, state: dict, arrivals, size: float, cfg: dict,
                device="cpu", follow=None) -> dict:
    """The step loop over one segment's arrivals ``(n (T, B), comm (T, B,
    A))`` from ``state`` (as :func:`migrate` takes it), in float64.

    Returns per-step ``throughput``, ``active`` and ``blackholed`` (T, B),
    the totals ``admitted``, ``drops``, ``fct_sum``, ``fct_count`` (B,),
    ``full`` (B,): whether an instance ever had fewer free slots than a
    step's arrivals, and the end ``state``.

    ``follow``, when given, is another run's state at the end of each of
    the segment's steps (each as :func:`migrate` takes a state).  Each step
    then starts from that run's state at the end of the step before
    (``state`` for the first), so that every step is one step of these
    rules from the other run's own state; a flow whose remainder lies
    within ``DONE_ABS`` of the completion threshold, where rounding decides,
    completes where that run's did.  The end of every step is returned as
    ``states``."""
    dtype = torch.float64
    dev = torch.device(device)
    B = len(routes)
    P = max(r.n_paths for r in routes)
    L = max(r.path_edges.shape[1] for r in routes)
    S = max(r.n_slots for r in routes)
    K = max(len(r.demands) for r in routes)
    pe = np.full((B, P + 1, L), S, dtype=np.int64)
    cap = np.full((B, S), np.inf)
    sval = np.zeros((B, S), dtype=bool)
    counts = np.zeros((B, K), dtype=np.int64)
    for b, r in enumerate(routes):
        pe[b, : r.n_paths, : r.path_edges.shape[1]] = np.where(
            r.path_edges >= r.n_slots, S, r.path_edges)
        cap[b, : r.n_slots] = 1.0
        sval[b, : r.n_slots] = True
        counts[b, : len(r.demands)] = np.bincount(r.path_owner,
                                                  minlength=len(r.demands))
    D = int(counts.max())
    rows = np.full((B, K, D), P, dtype=np.int64)
    for b, r in enumerate(routes):
        first = np.concatenate([[0], np.cumsum(counts[b, : len(r.demands)])[:-1]])
        for j in range(D):
            ok = counts[b, : len(r.demands)] > j
            rows[b, : len(r.demands)][ok, j] = first[ok] + j
    t = lambda x, dt=None: torch.as_tensor(x, device=dev, dtype=dt)  # noqa: E731
    pe_t = t(pe)
    pe_w = pe_t[:, :P]
    loads = _loads_fn(pe_w, S, dtype, False)
    cap_t, sval_t = t(cap, dtype), t(sval)
    inv = torch.where(sval_t, 1.0 / cap_t, torch.zeros_like(cap_t))
    rows_t, cnt_t = t(rows), t(counts)
    n_arr, comm_arr = (t(np.asarray(x), torch.int64) for x in arrivals)
    T, _, A = comm_arr.shape
    F = state["row"].shape[1]
    ar_a, ar_d = torch.arange(A, device=dev), torch.arange(D, device=dev)
    bidx = torch.arange(B, device=dev)

    row0 = np.where(state["row"] >= 0, state["row"], P)
    row = t(row0, torch.int64)
    rem = t(np.asarray(state["rem"], np.float64), dtype)
    age = t(np.asarray(state["age"], np.float64), dtype)
    hold = t(state["hold"], torch.int64)
    rel0 = np.zeros((B, S))
    for b, r in enumerate(routes):
        rel0[b, : r.n_slots] = state["rel"][b]
    rel_prev = t(rel0, dtype)
    fct_sum = torch.zeros(B, dtype=torch.float64, device=dev)
    fct_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    admitted = torch.zeros(B, dtype=torch.int64, device=dev)
    drops = torch.zeros(B, dtype=torch.int64, device=dev)
    bh_tot = t(np.asarray(state["bh"], np.float64), dtype)
    full = torch.zeros(B, dtype=torch.bool, device=dev)
    thr_t, act_t, bh_t, states = [], [], [], []
    bh_rate, dt = float(cfg["bh_rate"]), float(cfg["dt"])

    def host_state():
        row_h, rel_h = row.cpu().numpy(), rel_prev.cpu().numpy()
        return {"row": np.where(row_h < P, row_h, -1),
                "rem": rem.cpu().numpy(), "age": age.cpu().numpy(),
                "fid": np.zeros((B, F), dtype=np.int64),
                "hold": hold.cpu().numpy(), "bh": bh_tot.cpu().numpy(),
                "rel": [rel_h[b, : r.n_slots] for b, r in enumerate(routes)],
                "util": [np.zeros(r.n_slots) for r in routes]}

    for step in range(T):
        if follow is not None and step:
            prev = follow[step - 1]
            row = t(np.where(prev["row"] >= 0, prev["row"], P), torch.int64)
            rem = t(np.asarray(prev["rem"], np.float64), dtype)
            age = t(np.asarray(prev["age"], np.float64), dtype)
            hold = t(prev["hold"], torch.int64)
            rel0 = np.zeros((B, S))
            for b, r in enumerate(routes):
                rel0[b, : r.n_slots] = prev["rel"][b]
            rel_prev = t(rel0, dtype)
            bh_tot = t(np.asarray(prev["bh"], np.float64), dtype)
        n_p = n_arr[step]
        n_new = torch.clamp_max(n_p, A)
        drops += n_p - n_new
        comm = comm_arr[step]
        crows = rows_t[bidx[:, None], comm]  # (B, A, D)
        ccnt = cnt_t[bidx[:, None], comm]
        live = (ar_a[None, :] < n_new[:, None]) & (ccnt > 0)
        relp = torch.cat([rel_prev, rel_prev.new_zeros((B, 1))], dim=1)
        hops = pe_t[bidx[:, None, None], crows]  # (B, A, D, L)
        hop_util = relp[bidx[:, None, None, None], hops]
        util = hop_util.amax(dim=3)
        valid = ar_d[None, None, :] < ccnt[:, :, None]
        util = torch.where(valid, util, float("inf"))
        j = torch.argmin(util, dim=2)
        prow = torch.gather(crows, 2, j[..., None])[..., 0]
        order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
        live = torch.gather(live, 1, order)
        prow = torch.gather(prow, 1, order)
        free = row == P
        n_free = free.sum(dim=1)
        full |= n_free < A
        target = torch.argsort((~free).to(torch.int8), dim=1, stable=True)[:, :A]
        place = live & (ar_a[None, :] < n_free[:, None])

        def put(x, new):
            cur = torch.gather(x, 1, target)
            return x.scatter(1, target, torch.where(place, new, cur))

        row = put(row, prow)
        rem = put(rem, torch.full_like(prow, size, dtype=dtype))
        age = put(age, torch.zeros_like(prow, dtype=dtype))
        hold = put(hold, torch.zeros_like(prow))
        drops += (live & ~place).sum(dim=1)
        admitted += place.sum(dim=1)
        active = row < P
        held = active & (hold > 0)
        flowing = active & ~held
        nflow = torch.zeros((B, P + 1), dtype=dtype, device=dev)
        nflow.scatter_add_(1, row, flowing.to(dtype))
        rate_p, ld = _waterfill(loads, pe_w, nflow[:, :P], cap_t, sval_t,
                                cfg["wf_iters"])
        rel = ld * inv
        r_f = torch.gather(torch.cat([rate_p, rate_p.new_zeros((B, 1))], 1),
                           1, row)
        delivered = torch.minimum(rem, r_f * dt) * flowing.to(dtype)
        bh = torch.where(held, torch.clamp_max(rem, bh_rate * dt), 0.0)
        rem = rem - delivered - bh
        age = torch.where(active, age + 1.0, age)
        fin = active & (rem <= 1e-6)
        if follow is not None:
            edge = active & ((rem - 1e-6).abs() <= DONE_ABS) & (rem != 0)
            gone = t(follow[step]["row"] < 0)
            fin = torch.where(edge, gone, fin)
        done = fin & ~held
        fct_sum += torch.where(done, age * dt, 0.0).sum(dim=1)
        fct_cnt += done.sum(dim=1)
        thr_t.append(delivered.sum(dim=1))
        bh_t.append(bh.sum(dim=1))
        bh_tot = bh_tot + bh.sum(dim=1)
        act_t.append((active & ~fin).sum(dim=1))
        hold = torch.where(fin, 0, torch.clamp_min(hold - 1, 0))
        row = torch.where(fin, P, row)
        rem = torch.where(fin, 0.0, rem)
        age = torch.where(fin, 0.0, age)
        rel_prev = rel
        if follow is not None:
            states.append(host_state())
    stack = lambda xs: torch.stack(xs).cpu().numpy()  # noqa: E731
    return {"throughput": stack(thr_t).astype(np.float64),
            "active": stack(act_t), "blackholed": stack(bh_t),
            "admitted": admitted.cpu().numpy(), "drops": drops.cpu().numpy(),
            "fct_sum": fct_sum.cpu().numpy(), "fct_count": fct_cnt.cpu().numpy(),
            "full": full.cpu().numpy(), "state": host_state(),
            "states": states}


def simulate_with_events(routes0, boundaries: list, segments: list,
                         size: float, cfg: dict, lag: int,
                         device="cpu") -> dict:
    """The whole call: ``segments`` is ``[(t0, n, comm)]`` in order, each
    segment after the first starting at its :class:`Boundary`'s step; the
    state migrates by :func:`migrate` at each boundary.  Returns the
    per-step series (T, B) and the totals over the call."""
    by_step = {b.step: b for b in boundaries}
    routes = list(routes0)
    state = empty_state(routes, cfg["max_flows"])
    parts = []
    tot = {k: 0 for k in ("admitted", "drops", "fct_sum", "fct_count")}
    full = np.zeros(len(routes), dtype=bool)
    for t0, n, comm in segments:
        b = by_step.get(int(t0))
        if b is not None:
            state, _ = migrate(state, routes, b.routes[-1], b.row_map,
                               b.slot_map, lag)
            routes = b.routes[-1]
        seg = run_segment(routes, state, (n, comm), size, cfg, device=device)
        state = seg["state"]
        parts.append(seg)
        for k in tot:
            tot[k] = tot[k] + seg[k]
        full |= seg["full"]
    cat = lambda f: np.concatenate([p[f] for p in parts], axis=0)  # noqa: E731
    return {"throughput": cat("throughput"), "active": cat("active"),
            "blackholed": cat("blackholed"), **tot, "full": full}
