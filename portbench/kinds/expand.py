"""Incremental expansion (paper §4.2): an operator grows the network.

Set-up builds the configuration's base Jellyfish (``jellyfish(switches,
ports, net_degree)``), a random server permutation on it, its routing table
and a cold MW solve.  One unit is one chain of expansion steps from that
base, each adding ``add_switches`` switches:

1. ``expand_to`` and ``extend_server_permutation`` (existing servers keep
   their peers), then ``update_path_system`` against the previous step's
   routing table;
2. a warm ``mw_concurrent_flow`` from the previous step's solution;
3. ``ops.power_iteration_lambda2`` of the grown topology.

Checked, on a sample of the window's chains drawn from the seed, against
``reference/``: every grown topology (edge for edge, from the frozen
construction), every delta routing table against the reference's full
enumeration, each warm solve's ``alpha_gap`` (as the probe's),
``alpha_shortfall``: how far the checked chains' alphas fall short of the
reference's own chains, on average over every checked step (a cold float64
MW on the base, then each step's warm MW from the reference's previous
solution, started as ``reference/warm.py`` states; the mean over all the
checked chains' steps, since each step's gap swings by rounding either way,
by up to about half a percent, while a weaker solve lowers every step), and
``lambda2_gap``: the relative distance of each lambda_2 from the
reference's float64 power iteration from the same start block.  The
reference's MW solves run on the host, where their sums have one order, so
a seed's check reads the same every time.
"""

from __future__ import annotations

import types

import numpy as np

from portbench import roofline
from portbench.kinds.probe import (
    ALPHA_GAP_LIMIT,
    _as_system,
    same_tables,
    tables,
)
from portbench.reference import mw, paths, spectral
from portbench.reference.warm import warm_split
from portbench.reference.frozen import expansion as fexp
from portbench.reference.frozen import jellyfish as fjelly
from portbench.reference.frozen import traffic as ftraffic

#: Limits (PERF.md gives the readings each was set from).
LAMBDA2_GAP_LIMIT = 1e-5
ALPHA_SHORTFALL_LIMIT = 3e-3
#: Where the reference's MW solves run: the host's float64 sums keep one
#: order, where the card's scatter-adds race and move an alpha by up to
#: some tenths of a percent from run to run.
REF_DEVICE = "cpu"


class Driver:
    def __init__(self, cell, seed: int, device, spans) -> None:
        from repro_torch import kernels, obs
        from repro_torch.core import (
            build_path_system,
            expand_to,
            extend_server_permutation,
            jellyfish,
            mw_concurrent_flow,
            permutation_commodities,
            random_server_permutation,
            update_path_system,
        )
        from repro_torch.core.routing import clear_routing_cache
        from repro_torch.kernels import ops

        self.p = dict(build=build_path_system, expand=expand_to,
                      extend=extend_server_permutation, jellyfish=jellyfish,
                      mw=mw_concurrent_flow, comm=permutation_commodities,
                      perm=random_server_permutation,
                      update=update_path_system, lam=ops.power_iteration_lambda2)
        self.kernels, self.obs = kernels, obs
        self.clear_cache = clear_routing_cache
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev, self.spans = device, spans
        rng = np.random.default_rng(seed)
        self.base_seed, self.perm_seed, self.warm_seed = (
            int(x) for x in rng.integers(2**31, size=3))
        self.rng = rng
        self.records: list[dict] = []

    def setup(self) -> None:
        cfg, tr, p = self.cfg, self.tr, self.p
        self.base = p["jellyfish"](cfg["switches"], cfg["ports"],
                                   cfg["net_degree"], seed=self.base_seed)
        self.perm0 = p["perm"](self.base.n_servers, seed=self.perm_seed)
        comm = p["comm"](self.base, self.perm0)
        self.ps0 = p["build"](self.base, comm, k=cfg["k"],
                              max_slack=cfg["max_slack"], device=self.dev)
        self.cold = p["mw"](self.ps0, iters=tr["cold_iters"], device=self.dev)
        self._chain(self.warm_seed)  # warm every step's shapes

    def _chain(self, chain_seed: int) -> list[dict]:
        cfg, tr, p = self.cfg, self.tr, self.p
        erng = np.random.default_rng(chain_seed)
        cur, ps, prev, perm = self.base, self.ps0, self.cold, self.perm0
        steps = []
        for s in range(tr["steps"]):
            with self.spans.span("topology"):
                new = p["expand"](cur, cur.n_switches + tr["add_switches"],
                                  cfg["ports"], cfg["net_degree"], seed=erng)
                perm = p["extend"](perm, new.n_servers, seed=erng)
                comm = p["comm"](new, perm)
            with self.spans.span("routing.delta"):
                ps_new = p["update"](ps, cur, new, comm, device=self.dev)
            with self.spans.span("flow.warm_solve"):
                warm = p["mw"](ps_new, iters=tr["warm_iters"], warm=prev,
                               device=self.dev)
            lam_seed = chain_seed + s
            with self.spans.span("spectral"):
                lam = p["lam"](new.adjacency(), iters=tr["lambda2_iters"],
                               block=tr["lambda2_block"], seed=lam_seed,
                               device=self.dev)
            steps.append({
                "edges": np.asarray(new.edges).copy(),
                "tables": tables(ps_new),
                "alpha": float(warm.alpha), "iters": int(warm.iters),
                "rates": np.asarray(warm.rates).copy(),
                "lambda2": float(lam), "lambda2_seed": lam_seed})
            cur, ps, prev = new, ps_new, warm
        return steps

    def before_window(self) -> None:
        self.obs.reset_metrics()
        self.kernels.reset_launch_counts()

    def unit(self) -> None:
        seed = int(self.rng.integers(2**31))
        self.records.append({"seed": seed, "steps": self._chain(seed)})

    def work(self, units: int) -> float:
        return float(units * self.tr["steps"])

    def layer(self) -> dict:
        work = roofline.Work()
        for rec in self.records:
            for st in rec["steps"]:
                t = st["tables"]
                work.add(roofline.call_work(int(t["path_len"].sum()),
                                            len(t["path_len"]),
                                            2 * t["n_edges"]),
                         st["iters"] + 1)
        c = self.obs.counter
        return {"steps": len(self.records) * self.tr["steps"],
                "spans": dict(self.spans.seconds),
                "spliced": c("route/update/spliced").to_value(),
                "enumerated": c("route/update/enumerated").to_value(),
                "congestion_work": work,
                "launches": self.kernels.launch_counts()}

    def release(self) -> None:
        self.base = self.ps0 = self.cold = None
        self.clear_cache()

    def check(self, rng) -> tuple[list, int]:
        cfg, tr = self.cfg, self.tr
        take = min(tr["check_units"], len(self.records))
        picks = sorted(rng.choice(len(self.records), size=take, replace=False))
        bad_top = bad_paths = 0
        a_gap = a_short = l_gap = 0.0
        failed = 0
        self.notes = {"alpha": [], "ref_alpha": [], "kept_share": [],
                      "lambda2": [], "alpha_gap": [], "alpha_shortfall": [],
                      "lambda2_gap": []}
        base = fjelly.jellyfish(cfg["switches"], cfg["ports"],
                                cfg["net_degree"], seed=self.base_seed)
        perm0 = ftraffic.random_server_permutation(base.n_servers,
                                                   seed=self.perm_seed)
        comm0 = ftraffic.permutation_commodities(base, perm0)
        routes0 = self._routes(base, comm0)
        dist0 = paths.hop_distances(base.n_switches, base.edges)
        cold = mw.mw_reference(routes0, tr["cold_iters"], device=REF_DEVICE)
        signed = []
        for i in picks:
            rec = self.records[i]
            wrong = False
            ua = ul = 0.0
            erng = np.random.default_rng(rec["seed"])
            cur, perm, comm_cur, routes, dist, rates = (
                base, perm0, comm0, routes0, dist0, cold["rates"])
            for st in rec["steps"]:
                new = fexp.expand_to(cur, cur.n_switches + tr["add_switches"],
                                     cfg["ports"], cfg["net_degree"], seed=erng)
                perm = ftraffic.extend_server_permutation(perm, new.n_servers,
                                                          seed=erng)
                comm = ftraffic.permutation_commodities(new, perm)
                if not np.array_equal(new.edges, st["edges"]):
                    bad_top += 1
                    wrong = True
                dist_new = paths.hop_distances(new.n_switches, new.edges)
                ref = self._routes(new, comm, dist_new)
                same = same_tables(st["tables"], ref)
                # the reference's own warm solve of this step
                x0, kept = warm_split(cur, comm_cur, routes, rates, new, comm,
                                      ref, cfg["k"], cfg["max_slack"], dist,
                                      dist_new)
                sol = mw.mw_reference(ref, tr["warm_iters"], device=REF_DEVICE,
                                      x_init=x0)
                cur, comm_cur, routes, dist, rates = (new, comm, ref, dist_new,
                                                      sol["rates"])
                if not same:
                    bad_paths += 1
                    wrong = True
                    continue
                got = mw.achieved_alpha(ref, st["rates"])
                g = abs(got - st["alpha"]) / abs(st["alpha"]) if st["alpha"] else float("inf")
                ua = max(ua, g if np.isfinite(g) else float("inf"))
                sf = (sol["alpha"] - st["alpha"]) / sol["alpha"]
                signed.append(sf)
                self.notes["alpha"].append(st["alpha"])
                self.notes["ref_alpha"].append(sol["alpha"])
                self.notes["kept_share"].append(kept)
                self.notes["alpha_gap"].append(g)
                self.notes["alpha_shortfall"].append(sf)
                lam = spectral.lambda2_reference(
                    new.adjacency(np.float64), tr["lambda2_iters"],
                    tr["lambda2_block"], st["lambda2_seed"], device=self.dev)
                g = abs(st["lambda2"] - lam) / lam if lam > 0 else float("inf")
                ul = max(ul, g if np.isfinite(g) else float("inf"))
                self.notes["lambda2"].append(st["lambda2"])
                self.notes["lambda2_gap"].append(g)
            a_gap, l_gap = max(a_gap, ua), max(l_gap, ul)
            failed += int(wrong or not ua <= ALPHA_GAP_LIMIT
                          or not ul <= LAMBDA2_GAP_LIMIT)
        a_short = max(0.0, float(np.mean(signed))) if signed else 0.0
        if not a_short <= ALPHA_SHORTFALL_LIMIT:
            failed = take  # the mean speaks for every checked chain
        checks = [("topology_mismatch", float(bad_top), 0.0),
                  ("path_mismatch", float(bad_paths), 0.0),
                  ("alpha_gap", a_gap, ALPHA_GAP_LIMIT),
                  ("alpha_shortfall", a_short, ALPHA_SHORTFALL_LIMIT),
                  ("lambda2_gap", l_gap, LAMBDA2_GAP_LIMIT)]
        return checks, failed

    def _routes(self, top, comm, dist=None):
        cfg = self.cfg
        return paths.route_tables(top.n_switches, top.edges, comm.src,
                                  comm.dst, comm.demand, cfg["k"],
                                  cfg["max_slack"], dist)


def install_control(driver) -> None:
    """Put the reference in the program's place, in the configuration's
    precision less one step: float32 with TF32 products.  The control's
    solves start cold (a warm start changes no product's precision)."""
    cfg = driver.cfg

    def route(top, comm, **kw):
        return _as_system(paths.route_tables(
            top.n_switches, top.edges, comm.src, comm.dst, comm.demand,
            cfg["k"], cfg["max_slack"]))

    def solve(ps, iters, device, **kw):
        sol = mw.mw_reference(ps, iters, control=True, device=device)
        return types.SimpleNamespace(alpha=sol["alpha"], iters=sol["iters"],
                                     rates=sol["rates"])

    def lam(adj, iters, block, seed, device):
        return spectral.lambda2_reference(adj, iters, block, seed,
                                          control=True, device=device)

    driver.p.update(
        build=route, expand=fexp.expand_to,
        extend=ftraffic.extend_server_permutation, jellyfish=fjelly.jellyfish,
        mw=solve, comm=ftraffic.permutation_commodities,
        perm=ftraffic.random_server_permutation,
        update=lambda ps, cur, new, comm, device: route(new, comm), lam=lam)
