"""Live fault injection for the sim: topology events mid-traffic (§4.3).

The port of ``repro/sim/events.py``.  ``simulate_events`` splits the
engine's step loop at each scheduled event step, applies the topology
delta per instance through the producers in ``core.failures`` /
``core.expansion``, repairs the routing with ``update_path_system`` on the
simulation's device, migrates the live carry on the host, and resumes:

* **surviving flows** — their path row exists in the new system (the
  composed ``row_map`` pedigree maps it) — keep ``rem``/``age``/``fid``/
  ``hold`` bit-exactly and merely follow their row's new index;
* **disrupted flows** — their row vanished — re-select a path among the
  new system's candidate rows per policy (``ecmp``: the same
  ``flow_hash`` over the new equal-cost set; ``ksp_lc``/``mptcp``:
  least-congested under the migrated link loads, the first minimum in
  stable row order).  If the old path physically died (a hop's directed
  slot has no image in the new topology), the flow blackholes its traffic
  for ``lag`` steps (``REPRO_SIM_EVENT_LAG``) before resuming;
* **killed flows** — their commodity lost all routes — free their slot;
  the undelivered remainder (summed in float64, then cast to float32) is
  accounted as blackholed volume.

CT-segment contract (INVARIANTS.md): with an EMPTY schedule the segmented
run — even when ``REPRO_SIM_EVENT_MAX_SEG`` forces splits — is
bit-identical to one unsegmented ``simulate`` call.  Each segment draws its
arrivals over its ABSOLUTE steps (``draw_arrivals`` re-seeds per absolute
step; a caller's ``arrivals`` callable receives the absolute steps), so
segment boundaries cannot perturb the stream, and a boundary with no delta
passes the device carry through untouched.

The migration runs in numpy on the host, as the reference's does, and the
carry goes back to the device in the engine's dtypes: ``row``/``hold``/
``fid`` int64 (``fid`` holding uint32 values), the empty-row sentinel the
new batch's ``p_max``.  Nothing on this path scatter-adds on the device
except the engine's own exact counts.

Volume conservation (``check_sim_state`` behind ``REPRO_CHECK=1``):
``offered == delivered + in-flight + blackholed`` per instance.

Spans and counters (host time only, INVARIANTS.md OB-1): each boundary
with events is the span ``sim/reroute``; inside it each event's
application to the whole batch (producer, delta routing, the composed row
and slot maps) is ``sim/apply_event`` with attribute ``kind``, and the
carry's migration is ``sim/migrate``.  ``sim/events/<kind>`` counts the
events applied, ``sim/migrations`` the migrated boundaries and
``sim/migrate/{survived,reselected,killed}`` their flows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import env
from .. import obs
from ..analysis.contracts import (
    check_carry_migration,
    check_sim_state,
    checks_enabled,
)
from ..core.expansion import expand_to
from ..core.failures import fail_links, fail_switches, heal_links
from ..core.flow import PathSystemBatch
from ..core.routing import build_path_system, update_path_system
from ..core.topology import edge_delta
from ..device import resolve
from .ecmp import flow_hash
from .engine import (
    POLICIES,
    SIM_MAX_STEPS,
    SimConfig,
    SimResult,
    _batch_inputs,
    _check_arrivals,
    _epoch_logits,
    _host,
    _init_carry,
    _run_steps,
    _sim_result,
    _size_params,
    draw_arrivals,
)

__all__ = [
    "EVENT_KINDS",
    "EVENT_LAG",
    "EVENT_MAX_SEG",
    "Event",
    "EventSimResult",
    "simulate_events",
    "validate_schedule",
]

#: Default detection/reconvergence lag (steps of blackholed traffic after a
#: path-killing event) and the forced segment-split length, both validated
#: once at import through the repro_torch.env registry.
EVENT_LAG = env.read("REPRO_SIM_EVENT_LAG")
EVENT_MAX_SEG = env.read("REPRO_SIM_EVENT_MAX_SEG")

EVENT_KINDS = ("fail_links", "fail_switches", "heal_links", "expand")


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled topology event, applied to EVERY instance of the batch
    (each with instance-decorrelated randomness) before step ``step`` runs.

    ``kind`` selects the producer: ``fail_links`` (``n_links`` exact count
    or ``fraction``), ``fail_switches`` (``fraction``), ``expand`` (``grow``
    switches added), ``heal_links`` (restores the edges removed by the
    earlier ``fail_links`` event named by ``heal_of`` — its ``tag``).
    Events sharing a step apply in schedule order.
    """

    step: int
    kind: str
    n_links: int | None = None
    fraction: float | None = None
    grow: int = 0
    heal_of: str | None = None
    seed: int = 0
    tag: str | None = None


@dataclasses.dataclass
class EventSimResult:
    """``simulate_events`` output: the merged ``SimResult`` (commodity
    accounting in the GLOBAL commodity space, stable across deltas) plus
    the per-boundary migration records ``sim.telemetry.event_summary``
    reduces."""

    result: SimResult
    events: list  # per-boundary dicts (step, kinds, migration counts, ...)
    boundaries: list  # segment start steps, ascending (first is 0)
    systems: list  # final per-instance PathSystems
    tops: list  # final per-instance Topologies
    lag: int


def validate_schedule(schedule: Sequence[Event], n_steps: int) -> None:
    """Reject malformed schedules with a ``ValueError`` naming the event.

    Checks: steps inside ``[0, n_steps)``, known kinds, the per-kind
    parameter present, unique tags, and every ``heal_of`` resolving to a
    ``fail_links`` tag scheduled no later than the heal.
    """
    seen_tags: dict[str, int] = {}
    fail_tags: dict[str, int] = {}
    for idx, ev in enumerate(schedule):
        where = f"schedule[{idx}]"
        if not isinstance(ev, Event):
            raise TypeError(f"{where}: expected an Event, got {type(ev)!r}")
        if ev.kind not in EVENT_KINDS:
            raise ValueError(
                f"{where}: unknown event kind {ev.kind!r}; "
                f"expected one of {EVENT_KINDS}"
            )
        if not 0 <= int(ev.step) < n_steps:
            raise ValueError(
                f"{where}: step {ev.step} outside [0, {n_steps})"
            )
        if ev.kind == "fail_links":
            if ev.n_links is None and ev.fraction is None:
                raise ValueError(
                    f"{where}: fail_links needs n_links or fraction"
                )
        elif ev.kind == "fail_switches":
            if ev.fraction is None:
                raise ValueError(f"{where}: fail_switches needs fraction")
        elif ev.kind == "expand":
            if int(ev.grow) < 1:
                raise ValueError(f"{where}: expand needs grow >= 1")
        else:  # heal_links
            if ev.heal_of is None:
                raise ValueError(
                    f"{where}: heal_links needs heal_of (the tag of the "
                    "fail_links event to invert)"
                )
            got = fail_tags.get(ev.heal_of)
            if got is None or got > int(ev.step):
                raise ValueError(
                    f"{where}: heal_of={ev.heal_of!r} does not name a "
                    "fail_links event scheduled at or before this step"
                )
        if ev.tag is not None:
            if ev.tag in seen_tags:
                raise ValueError(f"{where}: duplicate tag {ev.tag!r}")
            seen_tags[ev.tag] = int(ev.step)
            if ev.kind == "fail_links":
                fail_tags[ev.tag] = int(ev.step)


def _kept(ps) -> np.ndarray:
    """Global commodity ids of a system's routed (kept) commodities."""
    if ps.unrouted is None:
        return np.arange(ps.n_commodities, dtype=np.int64)
    return np.flatnonzero(~np.asarray(ps.unrouted))


def _slot_map(top_old, top_new) -> np.ndarray:
    """(2 E_old,) old directed slot -> new directed slot, -1 if removed."""
    E_o, E_n = top_old.n_edges, top_new.n_edges
    _, _, eid = edge_delta(top_old, top_new)
    sm = np.full(2 * E_o, -1, np.int64)
    ok = eid >= 0
    sm[:E_o][ok] = eid[ok]
    sm[E_o:][ok] = eid[ok] + E_n
    return sm


def _apply_event(ev: Event, top, ps, comm, instance: int, heal_store: dict,
                 dev: torch.device):
    """One event on one instance: mutate the topology, repair the routing
    on ``dev``.

    Randomized producers draw from ``default_rng([ev.seed, instance])`` so
    the schedule is deterministic per (event, instance) regardless of batch
    width or event order.  ``fail_links`` events with a ``tag`` park their
    removed-edge list in ``heal_store`` for the paired ``heal_links``.
    """
    rng = np.random.default_rng([int(ev.seed), int(instance)])
    if ev.kind == "fail_links":
        if ev.n_links is not None:
            top_new = fail_links(top, seed=rng, n_links=int(ev.n_links))
        else:
            top_new = fail_links(top, fraction=float(ev.fraction), seed=rng)
        if ev.tag is not None:
            heal_store[(ev.tag, instance)] = list(
                top_new.meta["edges_removed"]
            )
    elif ev.kind == "fail_switches":
        top_new = fail_switches(top, float(ev.fraction), seed=rng)
    elif ev.kind == "heal_links":
        edges = heal_store.pop((ev.heal_of, instance), None)
        if edges is None:
            raise ValueError(
                f"heal_links event references tag {ev.heal_of!r} but no "
                f"fail delta is stored for instance {instance}"
            )
        top_new = heal_links(top, edges)
    else:  # expand
        top_new = expand_to(
            top, top.n_switches + int(ev.grow), seed=rng
        )
    if top_new.meta.get("node_remap") is not None:
        raise ValueError(
            "simulate_events does not support node-renumbering deltas "
            f"(event kind {ev.kind!r} produced one)"
        )
    ps_new = update_path_system(ps, top, top_new, comm, device=dev)
    return top_new, ps_new


def _migrate_carry(
    carry: dict, old_batch, old_systems, new_systems, new_batch,
    new_inp: dict, comms, rm_tot, sm_tot, lag: int, cfg: SimConfig,
    policy: str, g_del: np.ndarray, g_off: np.ndarray, gdum: int,
    dev: torch.device,
):
    """Map a live carry across one boundary's composed topology delta.

    Returns ``(new_carry, record)``.  Surviving flows keep their state
    bit-exactly on their row's new index; disrupted flows re-select per
    policy (blackholing for ``lag`` steps when their old path physically
    died); flows whose commodity lost all routes are killed, their
    remaining volume added to the blackhole total.  Segment-local commodity
    accumulators are flushed into the global ledgers ``g_del``/``g_off``
    here because the next segment's kept-commodity space may differ.
    The state is read to the host, migrated in numpy, and written back to
    ``dev`` in the engine's dtypes.
    """
    row = _host(carry["row"])
    rem = _host(carry["rem"])
    age = _host(carry["age"])
    fid = _host(carry["fid"])
    hold = _host(carry["hold"])
    rel = _host(carry["rel_prev"])
    util_sum = _host(carry["util_sum"])
    comm_del = _host(carry["comm_del"])
    comm_off = _host(carry["comm_off"])
    bh_before = _host(carry["bh_sum"])
    bh_sum = bh_before.copy()
    B, F = row.shape
    P_o, P_n = old_batch.p_max, new_batch.p_max
    S_n = new_batch.s_max

    row_new = np.full((B, F), P_n, np.int64)
    rem_new = np.zeros_like(rem)
    age_new = np.zeros_like(age)
    fid_new = np.zeros_like(fid)
    hold_new = np.zeros((B, F), np.int64)
    rel_new = np.zeros((B, S_n), np.float32)
    util_new = np.zeros((B, S_n), np.float32)
    survived = np.zeros(B, np.int64)
    reselected = np.zeros(B, np.int64)
    killed = np.zeros(B, np.int64)
    fwd_maps = []

    for i in range(B):
        ps_o, ps_n = old_systems[i], new_systems[i]
        kept_o, kept_n = _kept(ps_o), _kept(ps_n)

        # segment-local commodity accumulators -> global ledgers
        g_del[i, kept_o] += comm_del[i, : len(kept_o)]
        g_off[i, kept_o] += comm_off[i, : len(kept_o)]
        g_del[i, gdum] += comm_del[i, -1]
        g_off[i, gdum] += comm_off[i, -1]

        # link-keyed state follows the composed directed-slot map
        sm = sm_tot[i]
        oks = sm >= 0
        rel_new[i, sm[oks]] = rel[i, : len(sm)][oks]
        util_new[i, sm[oks]] = util_sum[i, : len(sm)][oks]

        # row pedigree -> old-row -> new-row forward map
        rm = rm_tot[i]
        fwd = np.full(ps_o.n_paths, -1, np.int64)
        okr = rm >= 0
        fwd[rm[okr]] = np.flatnonzero(okr)
        fwd_maps.append(fwd)

        act = np.flatnonzero(row[i] < ps_o.n_paths)
        if not act.size:
            continue
        r_old = row[i, act]
        sv = fwd[r_old] >= 0

        s_idx = act[sv]
        row_new[i, s_idx] = fwd[r_old[sv]]
        rem_new[i, s_idx] = rem[i, s_idx]
        age_new[i, s_idx] = age[i, s_idx]
        fid_new[i, s_idx] = fid[i, s_idx]
        hold_new[i, s_idx] = hold[i, s_idx]
        survived[i] = int(s_idx.size)

        d_idx = act[~sv]
        if not d_idx.size:
            continue
        r_dead = r_old[~sv]
        owner_o = np.asarray(ps_o.path_owner)
        kglob = kept_o[owner_o[r_dead]]
        if kept_n.size:
            pos = np.searchsorted(kept_n, kglob)
            safe = np.minimum(pos, len(kept_n) - 1)
            routed = kept_n[safe] == kglob
            g_new = safe
        else:
            routed = np.zeros(len(r_dead), bool)
            g_new = np.zeros(len(r_dead), np.int64)

        # did the old path physically die?  (any hop slot without an image;
        # the per-instance sentinel slot maps to an alive dummy)
        sm_pad = np.concatenate([sm, np.zeros(1, np.int64)])
        hops_o = np.asarray(ps_o.path_edges)[r_dead]
        path_dead = (
            (sm_pad[np.minimum(hops_o, len(sm))] < 0).any(axis=1)
            if hops_o.size else np.zeros(len(r_dead), bool)
        )

        k_idx = d_idx[~routed]
        if k_idx.size:  # commodity unroutable: kill, account the remainder
            bh_sum[i] = np.float32(
                bh_sum[i] + np.asarray(rem[i, k_idx], np.float64).sum()
            )
            killed[i] = int(k_idx.size)

        r_idx = d_idx[routed]
        if r_idx.size:
            owner_n = np.asarray(ps_n.path_owner)
            # stable order: candidates enumerate in row order, matching
            # the engine's owner-table candidate tables
            ordr = np.argsort(owner_n, kind="stable")
            so = owner_n[ordr]
            gg = g_new[routed]
            first = np.searchsorted(so, gg, side="left")
            cnt = np.searchsorted(so, gg, side="right") - first
            if policy == "ecmp":
                src = np.asarray(comms[i].src)[kglob[routed]]
                dst = np.asarray(comms[i].dst)[kglob[routed]]
                h = flow_hash(src, dst, fid[i, r_idx], cfg.salt)
                j = (np.asarray(h, np.uint64)
                     % cnt.astype(np.uint64)).astype(np.int64)
            else:  # ksp_lc / mptcp subflows: least-congested, first argmin
                relp = np.concatenate(
                    [rel_new[i], np.zeros(1, np.float32)]
                )
                pe_n = np.asarray(ps_n.path_edges)
                j = np.zeros(len(r_idx), np.int64)
                for t in range(len(r_idx)):
                    cand = ordr[first[t]: first[t] + cnt[t]]
                    u = relp[np.minimum(pe_n[cand], len(relp) - 1)]
                    j[t] = int(np.argmin(u.max(axis=1))) if u.size else 0
            sel = ordr[first + j]
            row_new[i, r_idx] = sel
            rem_new[i, r_idx] = rem[i, r_idx]
            age_new[i, r_idx] = age[i, r_idx]
            fid_new[i, r_idx] = fid[i, r_idx]
            hold_new[i, r_idx] = np.where(
                path_dead[routed], lag, hold[i, r_idx]
            )
            reselected[i] = int(r_idx.size)

    if checks_enabled():
        check_carry_migration(
            row, row_new, rem, rem_new, age, age_new, fid, fid_new,
            hold, hold_new, fwd_maps, P_o, P_n, lag,
        )

    K_n = new_inp["n_comm"]

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    new_carry = dict(
        carry,
        row=on_dev(row_new), rem=on_dev(rem_new), age=on_dev(age_new),
        fid=on_dev(fid_new), hold=on_dev(hold_new), rel_prev=on_dev(rel_new),
        comm_del=torch.zeros((B, K_n + 1), dtype=torch.float32, device=dev),
        comm_off=torch.zeros((B, K_n + 1), dtype=torch.float32, device=dev),
        util_sum=on_dev(util_new), bh_sum=on_dev(bh_sum),
    )
    record = {
        "survived": survived,
        "disrupted": reselected + killed,
        "reselected": reselected,
        "killed": killed,
        "fct_sum_before": _host(carry["fct_sum"]),
        "fct_count_before": _host(carry["fct_cnt"], np.int32),
        "blackholed_before": bh_before,
        "blackholed_kills": bh_sum - bh_before,
    }
    return new_carry, record


def simulate_events(
    tops: Sequence,
    comms: Sequence,
    schedule: Sequence[Event],
    workload,
    *,
    systems: Sequence | None = None,
    policy: str = "ecmp",
    config: SimConfig | None = None,
    seed: int = 0,
    backend: str = "auto",
    k: int = 8,
    max_slack: int = 3,
    lag: int | None = None,
    max_seg: int | None = None,
    device: "str | torch.device" = "cuda",
    arrivals: Callable | None = None,
) -> EventSimResult:
    """Run the batched simulator on ``device`` with topology events
    injected mid-traffic.

    ``tops``/``comms`` are B per-instance topologies and (global)
    commodity sets; ``systems`` optionally supplies prebuilt
    ``PathSystem``s (otherwise each is built with ``k``/``max_slack`` on
    ``device``).  ``schedule`` is a sequence of :class:`Event`; every event
    applies to every instance.  ``lag`` overrides ``REPRO_SIM_EVENT_LAG``;
    ``max_seg`` overrides ``REPRO_SIM_EVENT_MAX_SEG`` (0 = split only at
    events).  ``backend`` is resolved per segment (an ``expand`` event
    grows the stack); the result's ``backend`` is the last segment's.

    ``arrivals`` is an optional callable ``(ts, logits_epochs,
    epoch_of_step) -> (n_poisson, comm, eleph)`` giving each segment's
    stream over its absolute steps ``ts`` from that segment's demand
    log-weights (the same seam as ``simulate(arrivals=)``); without it each
    segment draws with ``draw_arrivals(seed, ts, ...)``.

    The returned :class:`EventSimResult` carries a ``SimResult`` whose
    commodity axes live in the GLOBAL commodity space (``max(comm.k)``
    wide plus the dummy column), so fail -> heal chains report coherent
    per-commodity volumes even while the routed subset changes.
    """
    dev = resolve(device)
    cfg = config or SimConfig()
    if policy not in POLICIES:
        raise ValueError(f"unknown sim policy {policy!r}: expected {POLICIES}")
    lag = EVENT_LAG if lag is None else int(lag)
    if lag < 0:
        raise ValueError(f"lag must be >= 0, got {lag}")
    max_seg = EVENT_MAX_SEG if max_seg is None else int(max_seg)
    if max_seg < 0:
        raise ValueError(f"max_seg must be >= 0, got {max_seg}")
    T = int(workload.n_steps)
    if T > SIM_MAX_STEPS:
        raise ValueError(
            f"workload has {T} steps > REPRO_SIM_MAX_STEPS={SIM_MAX_STEPS}; "
            "raise the env cap or split the horizon"
        )
    if workload.demand_epochs is not None:
        raise ValueError(
            "simulate_events derives the demand distribution from each "
            "segment's routed commodities; demand-epoch workloads are not "
            "supported"
        )
    tops = list(tops)
    comms = list(comms)
    B = len(tops)
    if len(comms) != B:
        raise ValueError(f"{B} topologies but {len(comms)} commodity sets")
    validate_schedule(schedule, T)
    if systems is None:
        systems = [
            build_path_system(tops[i], comms[i], k=k, max_slack=max_slack,
                              device=dev)
            for i in range(B)
        ]
    else:
        systems = list(systems)
        if len(systems) != B:
            raise ValueError(f"{B} topologies but {len(systems)} systems")

    ev_by_step: dict[int, list[Event]] = {}
    for ev in sorted(schedule, key=lambda e: int(e.step)):  # stable
        ev_by_step.setdefault(int(ev.step), []).append(ev)
    marks = [0]
    for s in sorted(ev_by_step):
        if s != marks[-1]:
            marks.append(s)
    marks.append(T)
    segs = []
    for a, b in zip(marks[:-1], marks[1:]):
        t0 = a
        while t0 < b:
            t1 = min(b, t0 + max_seg) if max_seg > 0 else b
            segs.append((t0, t1))
            t0 = t1

    # Global commodity ledgers: wide enough for every instance's FULL
    # commodity set (ids are stable across deltas) and, so an empty
    # schedule reproduces ``simulate``'s array shapes bit-for-bit, at
    # least as wide as the first batch's (bucketed) envelope.  Allocated
    # once the first batch exists; the last column is the dummy.
    kg = max(int(c.k) for c in comms)
    gdum = kg
    g_del = None
    g_off = None
    sp = _size_params(workload)
    heal_store: dict = {}
    records: list = []
    thrs, nacts, bhs = [], [], []
    carry = None
    batch = None
    inp = None

    for t0, t1 in segs:
        evs = ev_by_step.get(t0)
        if evs:
            with obs.span("sim/reroute", step=int(t0), events=len(evs)):
                old_systems = list(systems)
                old_batch = batch
                rm_tot = [
                    np.arange(systems[i].n_paths, dtype=np.int64)
                    for i in range(B)
                ]
                sm_tot = [
                    np.arange(systems[i].n_slots, dtype=np.int64)
                    for i in range(B)
                ]
                for ev in evs:
                    obs.counter(f"sim/events/{ev.kind}").inc()
                    with obs.span("sim/apply_event", kind=ev.kind):
                        for i in range(B):
                            top_new, ps_new = _apply_event(
                                ev, tops[i], systems[i], comms[i], i,
                                heal_store, dev,
                            )
                            rm_step = ps_new.row_map
                            if rm_step is None:  # full rebuild: rows fresh
                                rm_tot[i] = np.full(ps_new.n_paths, -1,
                                                    np.int64)
                            else:
                                rm_step = np.asarray(rm_step, np.int64)
                                nt = np.full(len(rm_step), -1, np.int64)
                                ok = rm_step >= 0
                                nt[ok] = rm_tot[i][rm_step[ok]]
                                rm_tot[i] = nt
                            sm_step = _slot_map(tops[i], top_new)
                            st = np.full(len(sm_tot[i]), -1, np.int64)
                            ok = sm_tot[i] >= 0
                            st[ok] = sm_step[sm_tot[i][ok]]
                            sm_tot[i] = st
                            tops[i], systems[i] = top_new, ps_new
                batch = PathSystemBatch.from_systems(list(systems))
                inp = _batch_inputs(batch, policy, cfg, backend, dev)
                if carry is not None:
                    with obs.span("sim/migrate"):
                        carry, rec = _migrate_carry(
                            carry, old_batch, old_systems, systems, batch,
                            inp, comms, rm_tot, sm_tot, lag, cfg, policy,
                            g_del, g_off, gdum, dev,
                        )
                    rec["step"] = t0
                    rec["kinds"] = [e.kind for e in evs]
                    rec["tags"] = [e.tag for e in evs]
                    records.append(rec)
                    obs.counter("sim/migrations").inc()
                    obs.counter("sim/migrate/survived").inc(
                        int(np.sum(rec["survived"]))
                    )
                    obs.counter("sim/migrate/reselected").inc(
                        int(np.sum(rec["reselected"]))
                    )
                    obs.counter("sim/migrate/killed").inc(
                        int(np.sum(rec["killed"]))
                    )
        if batch is None:
            batch = PathSystemBatch.from_systems(list(systems))
            inp = _batch_inputs(batch, policy, cfg, backend, dev)
        K = inp["n_comm"]
        if g_del is None:
            gdum = max(kg, K)
            g_del = np.zeros((B, gdum + 1), np.float32)
            g_off = np.zeros((B, gdum + 1), np.float32)
        if carry is None:
            carry = _init_carry(B, cfg.max_flows, batch.p_max, batch.s_max,
                                K, cfg.nbins, dev)
        logits, eos = _epoch_logits(workload, batch, K, T)
        ts = np.arange(t0, t1)
        with obs.span("sim/segment", t0=int(t0), t1=int(t1),
                      steps=int(t1 - t0), backend=inp["backend"]):
            if arrivals is None:
                stream = draw_arrivals(seed, ts, workload.rate[t0:t1], logits,
                                       eos[t0:t1], sp[0], cfg.max_arrivals,
                                       device=dev)
            else:
                stream = _check_arrivals(
                    arrivals(ts, logits, eos[t0:t1]), t1 - t0, B,
                    cfg.max_arrivals, K, dev)
            thr, nact, bh = _run_steps(
                carry, inp, torch.as_tensor(logits, device=dev), eos[t0:t1],
                stream, sp, cfg, policy)
            thrs.append(_host(thr))
            nacts.append(_host(nact, np.int32))
            bhs.append(_host(bh))
        obs.counter("sim/segments").inc()

    comm_del = _host(carry["comm_del"])
    comm_off = _host(carry["comm_off"])
    demands_g = np.zeros((B, gdum + 1), np.float32)
    for i in range(B):
        kept = _kept(systems[i])
        g_del[i, kept] += comm_del[i, : len(kept)]
        g_off[i, kept] += comm_off[i, : len(kept)]
        g_del[i, gdum] += comm_del[i, -1]
        g_off[i, gdum] += comm_off[i, -1]
        demands_g[i, kept] = np.asarray(systems[i].demands, np.float32)

    result = _sim_result(
        carry, inp, cfg, T, policy,
        throughput=np.concatenate(thrs, axis=0),
        active=np.concatenate(nacts, axis=0),
        blackholed=np.concatenate(bhs, axis=0),
        comm_delivered=g_del, comm_offered=g_off, demands=demands_g)
    if checks_enabled():
        check_sim_state(result, name="simulate_events")
    return EventSimResult(
        result=result,
        events=records,
        boundaries=[t0 for t0, _ in segs],
        systems=systems,
        tops=tops,
        lag=lag,
    )
