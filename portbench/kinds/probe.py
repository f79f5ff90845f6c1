"""Capacity probes (paper §4, Fig 1c): the bisection's own unit.

One unit is one probe: ``capacity.jellyfish_same_equipment`` builds the
Jellyfish of the configuration's equipment hosting ``n`` servers, and
``capacity.probe_full_capacity`` routes the probe's random permutation
matrices (traffic seeds ``0 .. n_matrices - 1``) in one batched build and
solves them in one batched MW solve that stops at ``target_alpha``.

The traffic file gives the ladder of server counts.  Every window walks
it in the same order, cyclically, alternating from its two ends inwards
(first, last, second, second to last, ...), so that a window that ends
partway through a pass holds cheap and dear rungs alike; the seed draws
only each probe's topology seed.  Every seed thus runs the same sizes in
the same order.

Checked, on a sample of the window's probes drawn from the seed, against
``reference/``: the topology (edge for edge, from the frozen construction),
every routing table (path for path), the verdict where the reference's MW
alpha lies clear of 1; ``alpha_gap``, how far the alpha the program claims
lies from the alpha its own rates carry on the reference's table; and
``alpha_shortfall``, how far each solve's alpha (capped at the target)
falls short of the reference's MW on the same table, with the same budget
and target.
"""

from __future__ import annotations

import types

import numpy as np

from portbench import roofline
from portbench.reference import mw, paths
from portbench.reference.frozen import traffic as ftraffic
from portbench.reference.frozen.jellyfish import jellyfish_heterogeneous

#: alpha_gap's limit (PERF.md gives the readings it was set from).
ALPHA_GAP_LIMIT = 2e-6
#: alpha_shortfall's limit (PERF.md gives the readings it was set from).
ALPHA_SHORTFALL_LIMIT = 8e-3
#: The reference's verdict counts only where its best alpha over the whole
#: budget lies this far from 1 (the program's and the reference's MW
#: trajectories drift apart by rounding; PERF.md gives the drift read).
VERDICT_MARGIN = 0.03


def ladder(lad: dict) -> list:
    """The server counts from ``first`` to ``last`` by ``step``, in the
    walk's order: alternately from the two ends inwards."""
    up = list(range(lad["first"], lad["last"] + 1, lad["step"]))
    out = []
    while up:
        out.append(up.pop(0))
        if up:
            out.append(up.pop())
    return out


def spread_servers(total: int, n_switches: int) -> np.ndarray:
    per = total // n_switches
    servers = np.full(n_switches, per, dtype=np.int64)
    servers[: total - per * n_switches] += 1
    return servers


def tables(ps) -> dict:
    """The routing table of a program path system, as host arrays."""
    return {"path_edges": np.asarray(ps.path_edges),
            "path_len": np.asarray(ps.path_len),
            "path_owner": np.asarray(ps.path_owner),
            "demands": np.asarray(ps.demands), "n_edges": int(ps.n_edges)}


def same_tables(got: dict, ref) -> bool:
    """Path for path, in the same rows and order, with the same demands."""
    if got["n_edges"] != ref.n_edges or len(got["path_len"]) != ref.n_paths:
        return False
    sent = 2 * ref.n_edges
    w = max(got["path_edges"].shape[1], ref.path_edges.shape[1])
    a = np.pad(got["path_edges"], ((0, 0), (0, w - got["path_edges"].shape[1])),
               constant_values=sent)
    b = np.pad(ref.path_edges, ((0, 0), (0, w - ref.path_edges.shape[1])),
               constant_values=sent)
    return (np.array_equal(a, b)
            and np.array_equal(got["path_len"], ref.path_len)
            and np.array_equal(got["path_owner"], ref.path_owner)
            and np.array_equal(got["demands"].astype(np.float64), ref.demands))


def congestion_work(records) -> roofline.Work:
    """The MW solves' congestion work: per member, one fused call per
    iteration run and one for the last iterate's evaluation."""
    work = roofline.Work()
    for rec in records:
        for tab, res in zip(rec["tables"], rec["results"]):
            one = roofline.call_work(int(tab["path_len"].sum()),
                                     len(tab["path_len"]), 2 * tab["n_edges"])
            work.add(one, res["iters"] + 1)
    return work


class Driver:
    def __init__(self, cell, seed: int, device, spans) -> None:
        from repro_torch import capacity, kernels
        from repro_torch.core.routing import clear_routing_cache

        self.capacity, self.kernels = capacity, kernels
        self.clear_cache = clear_routing_cache
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev, self.spans = device, spans
        self.rungs = ladder(self.tr["servers"])
        self.rng = np.random.default_rng(seed)
        self.records: list[dict] = []

    def _probe(self, n: int, topo_seed: int) -> dict:
        cfg, tr = self.cfg, self.tr
        with self.spans.span("topology"):
            top = self.capacity.jellyfish_same_equipment(
                cfg["switches"], cfg["ports"], n, seed=topo_seed)
        with self.spans.around(self.capacity, "build_path_system_batch",
                               "routing.build"), \
                self.spans.around(self.capacity, "mw_concurrent_flow_batch",
                                  "flow.solve"):
            probe = self.capacity.probe_full_capacity(
                top, n_matrices=tr["n_matrices"], k=cfg["k"],
                iters=tr["iters"], device=self.dev)
        return {
            "servers": n, "seed": topo_seed,
            "edges": np.asarray(top.edges).copy(),
            "verdict": bool(probe.verdict),
            "tables": [tables(ps) for ps in probe.mw_systems],
            "results": [{"alpha": float(r.alpha), "iters": int(r.iters),
                         "rates": np.asarray(r.rates).copy(),
                         "method": r.method} for r in probe.mw_results],
        }

    def setup(self) -> None:
        # warm the kernels and the allocator on the largest rung, on a
        # topology of its own, then forget its routing state
        self._probe(max(self.rungs), int(self.rng.integers(2**31)))
        self.clear_cache()

    def before_window(self) -> None:
        from repro_torch import obs

        obs.reset_metrics()
        self.kernels.reset_launch_counts()

    def unit(self) -> None:
        n = self.rungs[len(self.records) % len(self.rungs)]
        self.records.append(self._probe(n, int(self.rng.integers(2**31))))

    def work(self, units: int) -> float:
        return float(units)

    def layer(self) -> dict:
        return {"probes": len(self.records),
                "mw_iters": sum(r["iters"] for rec in self.records
                                for r in rec["results"]),
                "spans": dict(self.spans.seconds),
                "congestion_work": congestion_work(self.records),
                "launches": self.kernels.launch_counts()}

    def release(self) -> None:
        self.clear_cache()

    def check(self, rng) -> tuple[list, int]:
        cfg, tr = self.cfg, self.tr
        take = min(tr["check_units"], len(self.records))
        picks = sorted(rng.choice(len(self.records), size=take, replace=False))
        bad_top = bad_paths = bad_verdict = 0
        gap = short = 0.0
        failed = 0
        self.notes = {"servers": [r["servers"] for r in self.records],
                      "iters": [[x["iters"] for x in r["results"]]
                                for r in self.records],
                      "checked": []}
        for i in picks:
            rec = self.records[i]
            wrong = False
            unit_gap = unit_short = 0.0
            note = {"servers": rec["servers"], "verdict": rec["verdict"],
                    "alpha": [r["alpha"] for r in rec["results"]],
                    "iters": [r["iters"] for r in rec["results"]],
                    "ref_alpha": [], "ref_iters": [], "ref_best": [],
                    "alpha_gap": [], "alpha_shortfall": []}
            self.notes["checked"].append(note)
            ref_top = jellyfish_heterogeneous(
                np.full(cfg["switches"], cfg["ports"]),
                spread_servers(rec["servers"], cfg["switches"]),
                seed=rec["seed"])
            if not np.array_equal(ref_top.edges, rec["edges"]):
                bad_top += 1
                wrong = True
            n = ref_top.n_switches
            dist = paths.hop_distances(n, ref_top.edges)
            best = []
            for m in range(tr["n_matrices"]):
                comm = ftraffic.random_permutation_traffic(ref_top, seed=m)
                ref = paths.route_tables(n, ref_top.edges, comm.src, comm.dst,
                                         comm.demand, cfg["k"],
                                         cfg["max_slack"], dist)
                if m >= len(rec["tables"]) or not same_tables(rec["tables"][m], ref):
                    bad_paths += 1
                    wrong = True
                    continue
                res = rec["results"][m]
                got = mw.achieved_alpha(ref, res["rates"])
                g = abs(got - res["alpha"]) / abs(res["alpha"]) if res["alpha"] else float("inf")
                unit_gap = max(unit_gap, g if np.isfinite(g) else float("inf"))
                sol = mw.mw_reference(ref, tr["iters"], target_alpha=tr["target_alpha"],
                                      device=self.dev)
                sf = mw.shortfall(res["alpha"], sol["alpha"], tr["target_alpha"])
                unit_short = max(unit_short, sf)
                note["alpha_shortfall"].append(sf)
                best.append(sol["best_full"])
                note["ref_alpha"].append(sol["alpha"])
                note["ref_iters"].append(sol["iters"])
                note["ref_best"].append(sol["best_full"])
                note["alpha_gap"].append(g)
            if best and len(best) == tr["n_matrices"]:
                low = min(best)
                if abs(low - 1.0) > VERDICT_MARGIN and (low >= 1.0) != rec["verdict"]:
                    bad_verdict += 1
                    wrong = True
            gap, short = max(gap, unit_gap), max(short, unit_short)
            failed += int(wrong or not unit_gap <= ALPHA_GAP_LIMIT
                          or not unit_short <= ALPHA_SHORTFALL_LIMIT)
        checks = [("topology_mismatch", float(bad_top), 0.0),
                  ("path_mismatch", float(bad_paths), 0.0),
                  ("verdict_mismatch", float(bad_verdict), 0.0),
                  ("alpha_gap", gap, ALPHA_GAP_LIMIT),
                  ("alpha_shortfall", short, ALPHA_SHORTFALL_LIMIT)]
        return checks, failed


def _as_system(r) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        path_edges=r.path_edges, path_len=r.path_len, path_owner=r.path_owner,
        demands=r.demands.astype(np.float32), n_edges=r.n_edges,
        n_paths=r.n_paths, n_slots=r.n_slots)


def install_control(driver) -> None:
    """Put the reference in the program's place, in the configuration's
    precision less one step: float32 with TF32 products."""
    cfg = driver.cfg

    def jellyfish_same_equipment(n_switches, ports, n_servers, seed):
        return jellyfish_heterogeneous(np.full(n_switches, ports),
                                       spread_servers(n_servers, n_switches),
                                       seed=seed)

    def probe_full_capacity(top, n_matrices, k, iters, device, **kw):
        systems, results = [], []
        for m in range(n_matrices):
            comm = ftraffic.random_permutation_traffic(top, seed=m)
            r = paths.route_tables(top.n_switches, top.edges, comm.src,
                                   comm.dst, comm.demand, k, cfg["max_slack"])
            sol = mw.mw_reference(r, iters, target_alpha=1.0, control=True,
                                  device=device)
            systems.append(_as_system(r))
            results.append(types.SimpleNamespace(
                alpha=sol["alpha"], iters=sol["iters"], rates=sol["rates"],
                method="control"))
        return types.SimpleNamespace(
            verdict=all(x.alpha >= 1.0 - 1e-6 for x in results),
            mw_systems=systems, mw_results=results)

    driver.capacity = types.SimpleNamespace(
        jellyfish_same_equipment=jellyfish_same_equipment,
        probe_full_capacity=probe_full_capacity,
        build_path_system_batch=None, mw_concurrent_flow_batch=None)
