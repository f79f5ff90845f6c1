"""The flow-level simulator (paper §5, Fig 9): a routing study at load.

Set-up builds the configuration's instances (``jellyfish(switches, ports,
net_degree, seed=i)`` with random-permutation commodities of traffic seed
``i``, for ``i < instances``) as one ``build_path_system_batch`` and warms
the simulator on an arrival stream of its own.  One unit is one
``sim.simulate`` call of ``steps`` steps over the whole batch, on an
arrival stream the benchmark draws with numpy from the run's seed: Poisson
counts of mean ``rate`` per instance and step, commodities drawn in
proportion to their demand, every flow of ``size``.

Checked, on a sample of the window's calls drawn from the seed, against
``reference/sim.py`` run on the reference's own routing tables and the same
arrivals: every routing table (path for path); the admission totals and
per-commodity offered volume (exact, in instances whose flow table never
ran short); ``prefix_gap``, the largest per-step difference of throughput
(relative) or of the active-flow count over the steps before the first
choice that rounding could decide; and over the whole call
``throughput_gap`` (total volume delivered, relative) and ``fct_gap``
(mean flow completion time, relative), the largest over the instances.
"""

from __future__ import annotations

import types

import numpy as np

from portbench import roofline
from portbench.kinds.probe import same_tables, tables
from portbench.reference import paths
from portbench.reference import sim as rsim
from portbench.reference.frozen import jellyfish as fjelly
from portbench.reference.frozen import traffic as ftraffic

#: Limits (PERF.md gives the readings each was set from).
PREFIX_GAP_LIMIT = 1e-5
THROUGHPUT_GAP_LIMIT = 3e-3
FCT_GAP_LIMIT = 8e-3


def reference_routes(cfg) -> list:
    """The configuration's routing tables, built by the reference."""
    out = []
    for s in range(cfg["instances"]):
        top = fjelly.jellyfish(cfg["switches"], cfg["ports"], cfg["net_degree"],
                               seed=s)
        comm = ftraffic.random_permutation_traffic(top, seed=s)
        out.append(paths.route_tables(top.n_switches, top.edges, comm.src,
                                      comm.dst, comm.demand, cfg["k"],
                                      cfg["max_slack"]))
    return out


def sim_cfg(cfg) -> dict:
    return {k: cfg[k] for k in ("max_flows", "nbins", "wf_iters", "dt")}


class Driver:
    def __init__(self, cell, seed: int, device, spans) -> None:
        from repro_torch import kernels
        from repro_torch.core import (
            build_path_system_batch,
            jellyfish,
            random_permutation_traffic,
        )
        from repro_torch.sim import SimConfig, simulate, steady_poisson

        self.kernels = kernels
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev, self.spans = device, spans
        self.rng = np.random.default_rng(seed)
        self.build = build_path_system_batch
        self.jellyfish, self.traffic = jellyfish, random_permutation_traffic
        self.simulate = simulate
        cfg = self.cfg
        self.sim_config = SimConfig(
            dt=cfg["dt"], wf_iters=cfg["wf_iters"], wf_rule=cfg["wf_rule"],
            max_flows=cfg["max_flows"], max_arrivals=cfg["max_arrivals"],
            nbins=cfg["nbins"])
        self.workload = steady_poisson(self.tr["steps"], rate=self.tr["rate"],
                                       size=self.tr["size"])
        #: set-up warms the step loop on a fifth of a call's steps: every
        #: shape of a call but the per-step outputs' length
        self.warm_steps = max(self.tr["steps"] // 5, 1)
        self.warm_workload = steady_poisson(self.warm_steps,
                                            rate=self.tr["rate"],
                                            size=self.tr["size"])
        self.records: list[dict] = []

    def setup(self) -> None:
        cfg = self.cfg
        tops = [self.jellyfish(cfg["switches"], cfg["ports"], cfg["net_degree"],
                               seed=s) for s in range(cfg["instances"])]
        comms = [self.traffic(t, seed=s) for s, t in enumerate(tops)]
        self.batch = self.build(tops, comms, k=cfg["k"],
                                max_slack=cfg["max_slack"], device=self.dev)
        self.demands = [np.asarray(ps.demands, np.float64)
                        for ps in self.batch.systems]
        self._run(self._stream(self.warm_steps), self.warm_workload)

    def _stream(self, T: int) -> tuple:
        """Poisson counts (T, B) and demand-weighted commodities (T, B, A)."""
        A = self.cfg["max_arrivals"]
        B = len(self.demands)
        n = self.rng.poisson(self.tr["rate"], size=(T, B)).astype(np.int64)
        comm = np.zeros((T, B, A), dtype=np.int64)
        for b, d in enumerate(self.demands):
            comm[:, b] = self.rng.choice(len(d), size=(T, A), p=d / d.sum())
        return n, comm

    def _run(self, stream, workload):
        n, comm = stream
        with self.spans.span("sim.simulate"):
            return self.simulate(
                self.batch, workload, policy=self.tr["policy"],
                config=self.sim_config,
                arrivals=(n, comm, np.zeros(comm.shape, dtype=bool)),
                device=self.dev)

    def before_window(self) -> None:
        self.kernels.reset_launch_counts()

    def unit(self) -> None:
        stream = self._stream(self.tr["steps"])
        res = self._run(stream, self.workload)
        self.records.append({
            "stream": stream, "throughput": np.asarray(res.throughput),
            "active": np.asarray(res.active),
            "admitted": np.asarray(res.admitted),
            "drops": np.asarray(res.drops),
            "comm_offered": np.asarray(res.comm_offered),
            "fct_sum": np.asarray(res.fct_sum, np.float64),
            "fct_count": np.asarray(res.fct_count)})

    def work(self, units: int) -> float:
        return float(units * self.tr["steps"])

    def layer(self) -> dict:
        steps = len(self.records) * self.tr["steps"]
        calls = 2 * self.cfg["wf_iters"] + 3  # loads calls a step
        work = roofline.Work()
        for ps in self.batch.systems:
            one = roofline.call_work(int(np.asarray(ps.path_len).sum()),
                                     ps.n_paths, ps.n_slots, fused=False)
            work.add(one, calls * steps)
        return {"steps": steps, "spans": dict(self.spans.seconds),
                "congestion_work": work,
                "launches": self.kernels.launch_counts()}

    def release(self) -> None:
        self.tables = [tables(ps) for ps in self.batch.systems]
        self.batch = None

    def check(self, rng) -> tuple[list, int]:
        cfg = self.cfg
        take = min(self.tr["check_units"], len(self.records))
        picks = sorted(rng.choice(len(self.records), size=take, replace=False))
        routes = reference_routes(cfg)
        bad_paths = sum(not same_tables(t, r)
                        for t, r in zip(self.tables, routes))
        bad_adm = 0
        prefix = thr_gap = fct_gap = 0.0
        failed = 0
        horizons = []
        for i in picks:
            rec = self.records[i]
            ref = rsim.simulate_reference(routes, rec["stream"],
                                          self.tr["size"], sim_cfg(cfg),
                                          device=self.dev)
            u_adm, u_pre, u_thr, u_fct = compare(rec, ref, routes)
            horizons.append(ref["horizon"].tolist())
            bad_adm += u_adm
            prefix, thr_gap, fct_gap = (max(prefix, u_pre), max(thr_gap, u_thr),
                                        max(fct_gap, u_fct))
            failed += int(bad_paths > 0 or u_adm > 0
                          or not u_pre <= PREFIX_GAP_LIMIT
                          or not u_thr <= THROUGHPUT_GAP_LIMIT
                          or not u_fct <= FCT_GAP_LIMIT)
        self.notes = {"horizons": horizons}
        checks = [("path_mismatch", float(bad_paths), 0.0),
                  ("admission_mismatch", float(bad_adm), 0.0),
                  ("prefix_gap", prefix, PREFIX_GAP_LIMIT),
                  ("throughput_gap", thr_gap, THROUGHPUT_GAP_LIMIT),
                  ("fct_gap", fct_gap, FCT_GAP_LIMIT)]
        return checks, failed


def _rel(a, b) -> float:
    return float(abs(a - b) / abs(b)) if b else float("inf")


def compare(rec: dict, ref: dict, routes) -> tuple:
    """(instances whose admission differs, prefix gap, throughput gap, FCT
    gap) of one simulated call against the reference's."""
    bad = 0
    prefix = thr = fct = 0.0
    for b, r in enumerate(routes):
        k = len(r.demands)
        if not ref["full"][b] and (
                rec["admitted"][b] != ref["admitted"][b]
                or rec["drops"][b] != ref["drops"][b]
                or not np.array_equal(rec["comm_offered"][b, :k].astype(np.float64),
                                      ref["comm_offered"][b, :k])):
            bad += 1
        h = int(ref["horizon"][b])
        if h:
            got, want = rec["throughput"][:h, b], ref["throughput"][:h, b]
            prefix = max(prefix, float(np.max(np.abs(got - want)
                                              / np.maximum(want, 1.0))),
                         float(np.max(np.abs(rec["active"][:h, b].astype(np.int64)
                                             - ref["active"][:h, b]))))
        thr = max(thr, _rel(float(rec["throughput"][:, b].astype(np.float64).sum()),
                            float(ref["throughput"][:, b].sum())))
        if rec["fct_count"][b] and ref["fct_count"][b]:
            fct = max(fct, _rel(rec["fct_sum"][b] / rec["fct_count"][b],
                                ref["fct_sum"][b] / ref["fct_count"][b]))
        else:
            fct = float("inf")
    return bad, prefix, thr, fct


def install_control(driver) -> None:
    """Put the reference in the program's place with one guarantee of the
    configuration broken: each flow's least-congested choice reads the
    link loads of the step before the previous one.  (The configuration
    states no precision: the step below float32, TF32 products, is not
    separated from the float32 program by any number a run can compare;
    PERF.md gives the readings.)"""
    reference_in_place(driver, stale=True)


def reference_in_place(driver, control: bool = False,
                       stale: bool = False) -> None:
    """Put ``reference/sim.py`` in the program's place: with ``control``
    in float32 with TF32 products; with ``stale`` with one guarantee
    broken, each flow's least-congested choice reading the link loads of
    the step before the previous one."""
    cfg, tr = driver.cfg, driver.tr
    routes = reference_routes(cfg)

    def control_build(tops, comms, **kw):
        systems = [types.SimpleNamespace(
            path_edges=r.path_edges, path_len=r.path_len,
            path_owner=r.path_owner, demands=r.demands.astype(np.float32),
            n_edges=r.n_edges, n_paths=r.n_paths, n_slots=r.n_slots)
            for r in routes]
        return types.SimpleNamespace(systems=systems)

    def control_simulate(batch, workload, arrivals, **kw):
        ref = rsim.simulate_reference(routes, arrivals[:2], tr["size"],
                                      sim_cfg(cfg), control=control,
                                      stale=stale, device=driver.dev)
        K = max(len(r.demands) for r in routes)
        off = np.zeros((len(routes), K + 1), np.float32)
        off[:, :K] = ref["comm_offered"]
        return types.SimpleNamespace(
            throughput=ref["throughput"], active=ref["active"],
            admitted=ref["admitted"], drops=ref["drops"], comm_offered=off,
            fct_sum=ref["fct_sum"], fct_count=ref["fct_count"])

    driver.build = control_build
    driver.simulate = control_simulate
