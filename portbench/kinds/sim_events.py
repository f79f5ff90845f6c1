"""Live topology events under load (paper §4.3 failures and repair, §4.2
expansion, in §5's flow-level simulator): links fail, heal and the fabric
grows while flows run.

Set-up builds the configuration's instances as ``kinds/sim.py`` does (one
``build_path_system_batch``) and warms the program on fixed streams that do
not depend on the run's seed: one ``simulate`` call, then one
``simulate_events`` call over a short schedule with every event kind of the
traffic's.  One unit is one ``simulate_events`` call of ``steps`` steps
over the whole batch, from the same base systems every time, with the
traffic's schedule (each randomized event's seed drawn from the run's
seed) and ``ksp_lc``; each segment's arrivals are drawn with numpy from the
run's seed as ``kinds/sim.py`` draws them, over the segment's routed
commodities in proportion to their demand.

Checked, on a sample of the window's calls drawn from the seed: the base
topologies and tables; then the sampled call is run again after the window
with the program's migration wrapped, so that the carry entering and
leaving each migration is recorded, and held against
``reference/events.py``:

* every event's topology against the frozen producers (edge for edge) and
  every routing table after every event against ``reference/paths.py``;
* each migration, from the carry that entered it: the survived, reselected
  and killed sets, survivors' state bit for bit, each reselection (save one
  the reference flags as a near tie) and its state, the blackholed total,
  the link state;
* every step of every segment, each from the program's own state at the
  end of the step before (the rerun records it): one step of the
  reference's rules, held flows included, against the program's state at
  the step's end.  Flow rows, ``hold`` and ages exactly (``step``
  mismatches; a completion that rounding decides follows the program's),
  and ``step_gap``, the largest relative gap of a flow's remainder, a
  link's load and the step's throughput and blackholed volume;
* that the rerun equals the window's call bit for bit (``rerun``
  mismatches: throughput, active flows and blackholed volume a step);
* over the window's call, ``throughput_gap`` and ``fct_gap`` against the
  reference's own run on the same arrivals and events, the admissions in
  instances whose flow table never ran short, and ``conservation_gap``:
  offered against delivered + in flight + blackholed, relative, per
  instance.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect

import numpy as np

from portbench.kinds.probe import same_tables, tables
from portbench.kinds.sim import reference_routes
from portbench.reference import events as revents
from portbench.reference.frozen import jellyfish as fjelly
from portbench.reference.frozen import traffic as ftraffic

#: Limits (PERF.md gives the readings each was set from); the exact
#: counts' limits are 0.
STEP_GAP_LIMIT = 1e-5
THROUGHPUT_GAP_LIMIT = 4e-3
FCT_GAP_LIMIT = 6e-3
CONSERVATION_GAP_LIMIT = 1e-6
#: The set-up's streams and event seeds: fixed, so that every run's set-up
#: does the same work.
WARM_SEED = 0x5EED
#: The set-up's schedule runs on this share of a unit's steps, its events
#: at the unit's relative steps.
WARM_SHARE = 10

#: Carry fields the check reads, host copies.
_FIELDS = ("row", "rem", "age", "fid", "hold", "rel_prev", "util_sum",
           "bh_sum")


def _host_carry(carry: dict) -> dict:
    return {f: carry[f].detach().cpu().numpy().copy() for f in _FIELDS}


def ref_cfg(cfg) -> dict:
    return {k: cfg[k] for k in ("max_flows", "nbins", "wf_iters", "dt",
                                "bh_rate")}


class Driver:
    def __init__(self, cell, seed: int, device, spans) -> None:
        from repro_torch import obs
        from repro_torch.core import (
            build_path_system_batch,
            jellyfish,
            random_permutation_traffic,
        )
        from repro_torch.core.routing import clear_routing_cache
        from repro_torch.sim import (
            Event,
            SimConfig,
            simulate,
            simulate_events,
            steady_poisson,
        )

        self.obs = obs
        self.program = importlib.import_module("repro_torch.sim.events")
        #: the program's functions this driver may put other code in place
        #: of (the control and the planted faults; the check's recorder)
        self.migrate = self.program._migrate_carry
        self.migrate_signature = inspect.signature(self.migrate)
        self.run_steps = self.program._run_steps
        self.apply_event = self.program._apply_event
        self.clear_cache = clear_routing_cache
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev, self.spans = device, spans
        self.rng = np.random.default_rng(seed)
        self.build = build_path_system_batch
        self.jellyfish, self.traffic = jellyfish, random_permutation_traffic
        self.simulate, self.simulate_events = simulate, simulate_events
        self.Event = Event
        cfg, tr = self.cfg, self.tr
        self.sim_config = SimConfig(
            dt=cfg["dt"], wf_iters=cfg["wf_iters"], wf_rule=cfg["wf_rule"],
            max_flows=cfg["max_flows"], max_arrivals=cfg["max_arrivals"],
            nbins=cfg["nbins"], bh_rate=cfg["bh_rate"])
        self.workload = steady_poisson(tr["steps"], rate=tr["rate"],
                                       size=tr["size"])
        self.warm_steps = max(tr["steps"] // WARM_SHARE, 1)
        self.warm_workload = steady_poisson(self.warm_steps, rate=tr["rate"],
                                            size=tr["size"])
        self.records: list[dict] = []

    # ---- the schedule and the arrivals --------------------------------- #

    def schedule(self, seeds, scale: int = 1) -> list[dict]:
        """The traffic's events, each with its seed, steps divided by
        ``scale``."""
        out = []
        for ev, s in zip(self.tr["events"], seeds):
            out.append(dict(ev, step=int(ev["step"]) // scale, seed=int(s)))
        return out

    def _drawer(self, rng, segments: list):
        """The arrivals callable: per segment, Poisson counts and
        commodities in proportion to the segment's demands, drawn with
        numpy; each segment's draw is kept in ``segments``."""
        A, rate = self.cfg["max_arrivals"], self.tr["rate"]

        def draw(ts, logits, eos):
            lg = np.asarray(logits, dtype=np.float64)[0]  # one demand epoch
            T, (B, K) = len(ts), lg.shape
            n = rng.poisson(rate, size=(T, B)).astype(np.int64)
            comm = np.zeros((T, B, A), dtype=np.int64)
            for b in range(B):
                ok = np.isfinite(lg[b])
                w = np.where(ok, np.exp(lg[b] - lg[b][ok].max()), 0.0)
                comm[:, b] = rng.choice(K, size=(T, A), p=w / w.sum())
            segments.append((int(ts[0]), n, comm))
            return n, comm, np.zeros((T, B, A), dtype=bool)

        return draw

    @staticmethod
    def _replay(segments: list):
        it = iter(segments)

        def draw(ts, logits, eos):
            t0, n, comm = next(it)
            assert t0 == int(ts[0]) and len(n) == len(ts)
            return n, comm, np.zeros(comm.shape, dtype=bool)

        return draw

    @contextlib.contextmanager
    def _in_place(self):
        """The driver's choice of the program's migration, step loop and
        event application in the program's place for one call."""
        p = self.program
        saved = p._migrate_carry, p._run_steps, p._apply_event
        p._migrate_carry, p._run_steps, p._apply_event = (
            self.migrate, self.run_steps, self.apply_event)
        try:
            yield
        finally:
            p._migrate_carry, p._run_steps, p._apply_event = saved

    def _events(self, sched, workload, arrivals):
        cfg = self.cfg
        with self._in_place(), self.spans.span("sim.events"):
            return self.simulate_events(
                self.tops, self.comms, [self.Event(**e) for e in sched],
                workload, systems=self.systems, policy=self.tr["policy"],
                config=self.sim_config, k=cfg["k"],
                max_slack=cfg["max_slack"], lag=cfg["lag"], max_seg=0,
                device=self.dev, arrivals=arrivals)

    # ---- the harness's calls -------------------------------------------- #

    def setup(self) -> None:
        cfg = self.cfg
        self.tops = [self.jellyfish(cfg["switches"], cfg["ports"],
                                    cfg["net_degree"], seed=s)
                     for s in range(cfg["instances"])]
        self.comms = [self.traffic(t, seed=s) for s, t in enumerate(self.tops)]
        batch = self.build(self.tops, self.comms, k=cfg["k"],
                           max_slack=cfg["max_slack"], device=self.dev)
        self.systems = list(batch.systems)
        rng = np.random.default_rng(WARM_SEED)
        T, A = self.warm_steps, cfg["max_arrivals"]
        n = rng.poisson(self.tr["rate"], size=(T, len(self.systems)))
        comm = np.zeros((T, len(self.systems), A), dtype=np.int64)
        for b, ps in enumerate(self.systems):
            d = np.asarray(ps.demands, np.float64)
            comm[:, b] = rng.choice(len(d), size=(T, A), p=d / d.sum())
        self.simulate(batch, self.warm_workload, policy=self.tr["policy"],
                      config=self.sim_config,
                      arrivals=(n.astype(np.int64), comm,
                                np.zeros(comm.shape, dtype=bool)),
                      device=self.dev)
        seeds = [WARM_SEED + i for i in range(len(self.tr["events"]))]
        self._events(self.schedule(seeds, WARM_SHARE), self.warm_workload,
                     self._drawer(rng, []))

    def before_window(self) -> None:
        self.obs.reset_metrics()

    def unit(self) -> None:
        seeds = [int(s) for s in self.rng.integers(2**31,
                                                   size=len(self.tr["events"]))]
        sched = self.schedule(seeds)
        segs: list = []
        res = self._events(sched, self.workload, self._drawer(self.rng, segs))
        r = res.result
        self.records.append({
            "schedule": sched, "segments": segs,
            "throughput": np.asarray(r.throughput),
            "admitted": np.asarray(r.admitted), "drops": np.asarray(r.drops),
            "fct_sum": np.asarray(r.fct_sum, np.float64),
            "fct_count": np.asarray(r.fct_count),
            "offered": np.asarray(r.comm_offered).sum(axis=1, dtype=np.float64),
            "delivered": np.asarray(r.comm_delivered).sum(axis=1,
                                                          dtype=np.float64),
            "active": np.asarray(r.active),
            "blackholed": np.asarray(r.blackholed),
            "inflight": np.asarray(r.inflight, np.float64),
            "blackholed_total": np.asarray(r.blackholed_total, np.float64),
            "migrations": [[int(np.sum(e[k])) for k in
                            ("survived", "reselected", "killed")]
                           for e in res.events]})

    def work(self, units: int) -> float:
        return float(units * self.tr["steps"])

    def layer(self) -> dict:
        c = self.obs.counter
        return {"steps": len(self.records) * self.tr["steps"],
                "boundaries": sum(len(r["migrations"]) for r in self.records),
                "spans": dict(self.spans.seconds),
                "survived": c("sim/migrate/survived").to_value(),
                "reselected": c("sim/migrate/reselected").to_value(),
                "killed": c("sim/migrate/killed").to_value()}

    def release(self) -> None:
        self.base_tables = [tables(ps) for ps in self.systems]
        self.base_edges = [np.asarray(t.edges).copy() for t in self.tops]
        self.clear_cache()

    # ---- the check ------------------------------------------------------ #

    def migrate_args(self, carry, *a, **kw) -> inspect.BoundArguments:
        """A call of the program's migration, its arguments by name."""
        return self.migrate_signature.bind(carry, *a, **kw)

    def _rerun(self, rec: dict) -> dict:
        """The recorded call again, with the program's event application,
        migration and step loop wrapped to record what enters and leaves
        them: the state at the end of every step too."""
        applied, moved, steps = [], [], []
        plain_apply, plain_migrate = self.apply_event, self.migrate
        plain_steps = self.run_steps

        def apply_event(ev, top, ps, comm, instance, heal_store, dev):
            top_new, ps_new = plain_apply(ev, top, ps, comm, instance,
                                          heal_store, dev)
            applied.append((np.asarray(top_new.edges).copy(), tables(ps_new)))
            return top_new, ps_new

        def migrate(carry, *a, **kw):
            arg = self.migrate_args(carry, *a, **kw).arguments
            cin = _host_carry(carry)
            rm_tot = [np.asarray(r).copy() for r in arg["rm_tot"]]
            new, out_rec = plain_migrate(carry, *a, **kw)
            moved.append({
                "in": cin, "out": _host_carry(new), "rm": rm_tot,
                "old_paths": [s.n_paths for s in arg["old_systems"]],
                "old_slots": [s.n_slots for s in arg["old_systems"]],
                "new_paths": [s.n_paths for s in arg["new_systems"]],
                "new_slots": [s.n_slots for s in arg["new_systems"]]})
            return new, out_rec

        def run_steps(c, inp, logits, eos, stream, *a):
            log: list = []
            out = plain_steps(_StepLog(c, log), inp, logits, eos, stream, *a)
            if len(log) != int(stream[0].shape[0]):
                raise RuntimeError(f"recorded {len(log)} step ends of "
                                   f"{int(stream[0].shape[0])} steps")
            steps.append(log)
            return out

        self.apply_event, self.migrate = apply_event, migrate
        self.run_steps = run_steps
        try:
            res = self._events(rec["schedule"], self.workload,
                               self._replay(rec["segments"]))
        finally:
            self.apply_event, self.migrate = plain_apply, plain_migrate
            self.run_steps = plain_steps
        return {"applied": applied, "moved": moved, "steps": steps,
                "result": res.result}

    def check(self, rng) -> tuple[list, int]:
        cfg, tr = self.cfg, self.tr
        take = min(tr["check_units"], len(self.records))
        picks = sorted(rng.choice(len(self.records), size=take, replace=False))
        B = cfg["instances"]
        ftops = [fjelly.jellyfish(cfg["switches"], cfg["ports"],
                                  cfg["net_degree"], seed=s) for s in range(B)]
        fcomms = [ftraffic.random_permutation_traffic(t, seed=s)
                  for s, t in enumerate(ftops)]
        routes0 = reference_routes(cfg)
        bad = dict.fromkeys(("topology", "path", "set", "survivor",
                             "reselect", "blackholed", "link", "admission"), 0)
        bad["topology"] = sum(not np.array_equal(a, t.edges)
                              for a, t in zip(self.base_edges, ftops))
        bad["path"] = sum(not same_tables(a, r)
                          for a, r in zip(self.base_tables, routes0))
        bad.update(step=0, rerun=0)
        gaps = dict.fromkeys(("step", "throughput", "fct", "conservation"),
                             0.0)
        notes = {"near_ties": 0, "migrations": [], "steps_compared": 0}
        failed = 0
        for u in picks:
            rec = self.records[u]
            before = dict(bad)
            chain = revents.event_chain(ftops, fcomms, rec["schedule"],
                                        cfg["k"], cfg["max_slack"], routes0)
            cap = self._rerun(rec)
            got = cap["result"]
            for key in ("throughput", "active", "blackholed"):
                a, b = np.asarray(getattr(got, key)), rec[key]
                bad["rerun"] += (int(np.sum(~np.all(a == b, axis=0)))
                                 if a.shape == b.shape else B)
            self._check_events(chain, cap, bad)
            self._check_migrations(routes0, chain, cap, bad, notes)
            self._check_segments(routes0, chain, cap, rec, bad, gaps, notes)
            self._check_call(routes0, chain, rec, bad, gaps)
            failed += int(any(bad[k] > before[k] for k in bad)
                          or not gaps["step"] <= STEP_GAP_LIMIT
                          or not gaps["throughput"] <= THROUGHPUT_GAP_LIMIT
                          or not gaps["fct"] <= FCT_GAP_LIMIT
                          or not gaps["conservation"] <= CONSERVATION_GAP_LIMIT)
        self.notes = notes
        checks = [(f"{k}_mismatch", float(v), 0.0) for k, v in bad.items()]
        checks += [("step_gap", gaps["step"], STEP_GAP_LIMIT),
                   ("throughput_gap", gaps["throughput"], THROUGHPUT_GAP_LIMIT),
                   ("fct_gap", gaps["fct"], FCT_GAP_LIMIT),
                   ("conservation_gap", gaps["conservation"],
                    CONSERVATION_GAP_LIMIT)]
        return checks, failed

    @staticmethod
    def _check_events(chain, cap, bad) -> None:
        want = [(b.tops[e][i], b.routes[e][i]) for b in chain
                for e in range(len(b.kinds)) for i in range(len(b.tops[e]))]
        got = cap["applied"]
        if len(got) != len(want):
            bad["topology"] += abs(len(got) - len(want))
        for (edges, tab), (top, routes) in zip(got, want):
            bad["topology"] += int(not np.array_equal(edges, top.edges))
            bad["path"] += int(not same_tables(tab, routes))

    def _check_migrations(self, routes0, chain, cap, bad, notes) -> None:
        if len(cap["moved"]) != len(chain):
            bad["set"] += abs(len(cap["moved"]) - len(chain))
        old = routes0
        for b, m in zip(chain, cap["moved"]):
            new = b.routes[-1]
            state = program_state(m["in"], m["old_paths"], m["old_slots"])
            ref, sets = revents.migrate(state, old, new, b.row_map,
                                        b.slot_map, self.cfg["lag"])
            got = program_state(m["out"], m["new_paths"], m["new_slots"])
            notes["migrations"].append([int(sum(len(x) for x in sets[k]))
                                        for k in ("survived", "reselected",
                                                  "killed")])
            for i in range(len(new)):
                act = np.flatnonzero(state["row"][i] >= 0)
                fwd = np.full(m["old_paths"][i], -1, dtype=np.int64)
                rm = m["rm"][i]
                fwd[rm[rm >= 0]] = np.flatnonzero(rm >= 0)
                p_surv = act[fwd[state["row"][i, act]] >= 0]
                p_kill = act[got["row"][i, act] < 0]
                p_resel = np.setdiff1d(act, np.union1d(p_surv, p_kill))
                appeared = np.flatnonzero((state["row"][i] < 0)
                                          & (got["row"][i] >= 0))
                if not (np.array_equal(p_surv, sets["survived"][i])
                        and np.array_equal(p_kill, sets["killed"][i])
                        and np.array_equal(p_resel,
                                           np.sort(sets["reselected"][i]))
                        and not appeared.size):
                    bad["set"] += 1
                s = sets["survived"][i]
                bad["survivor"] += int(np.sum(~_same_flows(got, ref, i, s)))
                r, ties = sets["reselected"][i], sets["near_tie"][i]
                notes["near_ties"] += int(ties.sum())
                ok_row = (got["row"][i, r] == ref["row"][i, r]) | ties
                ok_state = _same_flows(got, ref, i, r, fields=(
                    "rem", "age", "fid", "hold"))
                bad["reselect"] += int(np.sum(~(ok_row & ok_state)))
                bad["blackholed"] += int(
                    got["bh"][i].tobytes() != ref["bh"][i].tobytes())
                bad["link"] += int(not (
                    np.array_equal(got["rel"][i], ref["rel"][i])
                    and np.array_equal(got["util"][i], ref["util"][i])
                    and not m["out"]["rel_prev"][i, len(ref["rel"][i]):].any()))
            old = new

    def _check_segments(self, routes0, chain, cap, rec, bad, gaps,
                        notes) -> None:
        """Every step of every segment from the program's own state at the
        end of the step before: one step of the reference's rules against
        the program's state at the step's end."""
        res = cap["result"]
        thr, bhs = np.asarray(res.throughput), np.asarray(res.blackholed)
        routes = routes0
        n_paths = [s.n_paths for s in self.systems]
        n_slots = [s.n_slots for s in self.systems]
        B = len(routes0)
        for j, ((t0, n, comm), log) in enumerate(zip(rec["segments"],
                                                     cap["steps"])):
            if j == 0:
                state = revents.empty_state(routes, self.cfg["max_flows"])
            else:
                m = cap["moved"][j - 1]
                routes = chain[j - 1].routes[-1]
                n_paths, n_slots = m["new_paths"], m["new_slots"]
                state = program_state(m["out"], n_paths, n_slots)
            follow = [program_state(c, n_paths, n_slots) for c in log]
            ref = revents.run_segment(routes, state, (n, comm),
                                      self.tr["size"], ref_cfg(self.cfg),
                                      device=self.dev, follow=follow)
            for s, (got, want) in enumerate(zip(follow, ref["states"])):
                notes["steps_compared"] += B
                t = t0 + s
                for b in range(B):
                    bad["step"] += int(not (
                        np.array_equal(got["row"][b], want["row"][b])
                        and np.array_equal(got["hold"][b], want["hold"][b])
                        and np.array_equal(got["age"][b].astype(np.float64),
                                           want["age"][b])))
                    rem_w = want["rem"][b]
                    gap = max(
                        float(np.max(np.abs(got["rem"][b] - rem_w)
                                     / np.maximum(np.abs(rem_w), 1.0))),
                        float(np.max(np.abs(got["rel"][b] - want["rel"][b]),
                                     initial=0.0)),
                        _rel_step(thr[t, b], ref["throughput"][s, b]),
                        _rel_step(bhs[t, b], ref["blackholed"][s, b]))
                    gaps["step"] = max(gaps["step"], gap)
        if len(cap["steps"]) != len(rec["segments"]):
            bad["step"] += abs(len(cap["steps"]) - len(rec["segments"])) * B

    def _check_call(self, routes0, chain, rec, bad, gaps) -> None:
        ref = revents.simulate_with_events(
            routes0, chain, rec["segments"], self.tr["size"],
            ref_cfg(self.cfg), self.cfg["lag"], device=self.dev)
        for b in range(len(routes0)):
            if not ref["full"][b] and (rec["admitted"][b] != ref["admitted"][b]
                                       or rec["drops"][b] != ref["drops"][b]):
                bad["admission"] += 1
            gaps["throughput"] = max(gaps["throughput"], _rel(
                float(rec["throughput"][:, b].astype(np.float64).sum()),
                float(ref["throughput"][:, b].sum())))
            if rec["fct_count"][b] and ref["fct_count"][b]:
                gaps["fct"] = max(gaps["fct"], _rel(
                    rec["fct_sum"][b] / rec["fct_count"][b],
                    ref["fct_sum"][b] / ref["fct_count"][b]))
            else:
                gaps["fct"] = float("inf")
            off = rec["offered"][b]
            lhs = (rec["delivered"][b] + rec["inflight"][b]
                   + rec["blackholed_total"][b])
            gaps["conservation"] = max(gaps["conservation"],
                                       abs(off - lhs) / max(off, 1.0))


def program_state(c: dict, n_paths, n_slots) -> dict:
    """A host copy of the program's carry as ``reference/events.py`` takes
    a state: an empty slot as row -1, each instance's link state over its
    own slots."""
    row = c["row"].copy()
    for i, p in enumerate(n_paths):
        row[i][row[i] >= p] = -1
    return {"row": row, "rem": c["rem"], "age": c["age"], "fid": c["fid"],
            "hold": c["hold"], "bh": c["bh_sum"],
            "rel": [c["rel_prev"][i, :s] for i, s in enumerate(n_slots)],
            "util": [c["util_sum"][i, :s] for i, s in enumerate(n_slots)]}


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x)
    return x.view(np.dtype(f"i{x.itemsize}")) if x.dtype.kind == "f" else x


def _same_flows(got, want, i, idx, fields=("row", "rem", "age", "fid",
                                           "hold")) -> np.ndarray:
    """Per flow of ``idx``: every field equal bit for bit."""
    ok = np.ones(len(idx), dtype=bool)
    for f in fields:
        a, b = got[f][i, idx], want[f][i, idx]
        ok &= (_bits(a) == _bits(b)) if a.dtype == b.dtype else False
    return ok


def _rel(a, b) -> float:
    return float(abs(a - b) / abs(b)) if b else float("inf")


def _rel_step(got, want) -> float:
    return float(abs(float(got) - want) / max(abs(want), 1.0))


class _StepLog(dict):
    """The program's carry, keeping a host copy of the carry at the end of
    each step in ``log``: the step loop writes ``rel_prev`` last in a step
    (``_rerun`` checks that one copy was kept a step)."""

    def __init__(self, carry: dict, log: list) -> None:
        super().__init__(carry)
        self.carry, self.log = carry, log

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self.carry[key] = value
        if key == "rel_prev":
            self.log.append(_host_carry(self))


def install_control(driver) -> None:
    """The program with one stated rule broken: each disrupted flow
    re-selects under the link loads of the step before the previous one
    (as ``kinds/sim.py``'s control reads them for every choice); the link
    state the next segment starts from is left as it is."""
    plain_steps, plain_migrate = driver.run_steps, driver.migrate
    older: dict = {}

    def run_steps(c, inp, logits, eos, stream, sp, cfg, policy):
        T = int(stream[0].shape[0])
        if T < 2:
            older.clear()
            return plain_steps(c, inp, logits, eos, stream, sp, cfg, policy)
        import torch

        head = plain_steps(c, inp, logits, eos[: T - 1],
                           tuple(x[: T - 1] for x in stream), sp, cfg, policy)
        older["rel"] = c["rel_prev"].clone()
        tail = plain_steps(c, inp, logits, eos[T - 1:],
                           tuple(x[T - 1:] for x in stream), sp, cfg, policy)
        return tuple(torch.cat([a, b]) for a, b in zip(head, tail))

    def migrate(carry, *a, **kw):
        true, rec = plain_migrate(carry, *a, **kw)
        if "rel" not in older:
            return true, rec
        arg = driver.migrate_args(carry, *a, **kw).arguments
        # the ledgers are flushed once: the stale call flushes into copies
        arg.update(carry=dict(carry, rel_prev=older["rel"]),
                   g_del=arg["g_del"].copy(), g_off=arg["g_off"].copy())
        stale, _ = plain_migrate(**arg)
        return dict(stale, rel_prev=true["rel_prev"]), rec

    driver.run_steps, driver.migrate = run_steps, migrate
