"""LEGUP-style Clos expansion baseline (paper §4.2, Fig 6).

LEGUP (Curtis et al., CoNEXT'10) finds budget-constrained upgrades of Clos
networks, reserving free ports to ease later expansion.  The original
implementation is not public (the paper's authors shared topology files with
the Jellyfish authors); we reimplement the *behavioral essence* as a greedy
heuristic with a transparent cost model so the Jellyfish-vs-Clos expansion
economics can be reproduced end to end:

* cost model (documented constants): switch = $500 + $50/port,
  cable = $100/link installed, rewire = $50/move — same constants applied to
  BOTH arcs, so only the *relative* numbers matter.
* LEGUP arc: stage 0 builds a Clos for the initial server count; each stage
  has a budget; the heuristic buys spine switches and rewires leaf uplinks to
  maximize Clos bisection, but (like LEGUP) reserves ``reserve_frac`` of new
  spine ports for future stages.
* Jellyfish arc: the same budgets buy the same switch hardware, which is
  randomly cabled in via the paper's expansion procedure; no ports reserved.

Both arcs are scored with the same estimator (Kernighan–Lin balanced cut,
normalized by server bandwidth).  ``benchmarks/fig6_legup.py`` reports the
cost at which Jellyfish first matches LEGUP's final-stage bisection —
the paper's headline is "equivalent network at 60% lower cost".

Port copy of ``repro/core/legup.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bisection import normalized_bisection
from .clos import ClosSpec, build_clos
from .expansion import add_switch, rewire_free_ports
from .jellyfish import jellyfish
from .topology import Topology

__all__ = ["CostModel", "ExpansionStage", "legup_arc", "jellyfish_arc"]


@dataclasses.dataclass
class CostModel:
    switch_base: float = 500.0
    per_port: float = 50.0
    cable: float = 100.0
    rewire: float = 50.0

    def switch(self, ports: int) -> float:
        return self.switch_base + self.per_port * ports


@dataclasses.dataclass
class ExpansionStage:
    budget: float
    add_servers: int = 0  # servers added this stage (same for both arcs)


@dataclasses.dataclass
class ArcPoint:
    stage: int
    cum_cost: float
    n_servers: int
    n_switches: int
    bisection: float


def legup_arc(
    stages: list[ExpansionStage],
    k_ports: int = 24,
    servers_per_leaf: int = 16,
    reserve_frac: float = 0.25,
    cost: CostModel | None = None,
) -> list[ArcPoint]:
    """Greedy LEGUP-like Clos expansion under per-stage budgets."""
    cost = cost or CostModel()
    # Stage 0: build initial Clos for stages[0].add_servers servers.
    n0 = stages[0].add_servers
    leaves = int(np.ceil(n0 / servers_per_leaf))
    uplinks = k_ports - servers_per_leaf
    # initial spines: enough ports for leaf uplinks, PLUS the LEGUP-style
    # reservation headroom (buy bigger, leave ports free).
    need_ports = leaves * uplinks
    spines = int(np.ceil(need_ports * (1 + reserve_frac) / k_ports))
    spec = ClosSpec(leaves, servers_per_leaf, uplinks, spines, k_ports)
    cum = (
        (leaves + spines) * cost.switch(k_ports)
        + leaves * servers_per_leaf * cost.cable
        + need_ports * cost.cable
    )
    top = build_clos(spec, name="legup-clos")
    points = [
        ArcPoint(0, cum, spec.n_servers, spec.n_switches, normalized_bisection(top))
    ]
    for si, st in enumerate(stages[1:], start=1):
        budget = st.budget
        moved = 0
        if st.add_servers:
            add_leaves = int(np.ceil(st.add_servers / servers_per_leaf))
            budget -= add_leaves * (
                cost.switch(k_ports) + servers_per_leaf * cost.cable
            )
            budget -= add_leaves * uplinks * cost.cable
            spec.n_leaves += add_leaves
        # spend the rest on spines (respecting the reservation discipline:
        # a spine's usable ports this stage are (1 - reserve_frac) * k)
        while budget >= cost.switch(k_ports):
            budget -= cost.switch(k_ports)
            spec.n_spines += 1
            # rewiring leaf uplinks onto the new spine costs rewire fees
            moves = min(int((1 - reserve_frac) * k_ports), spec.n_leaves)
            budget -= moves * cost.rewire
            moved += moves
        cum += st.budget - max(budget, 0.0)
        top = build_clos(spec, name="legup-clos")
        points.append(
            ArcPoint(si, cum, spec.n_servers, spec.n_switches, normalized_bisection(top))
        )
    return points


def jellyfish_arc(
    stages: list[ExpansionStage],
    k_ports: int = 24,
    servers_per_switch: int = 16,
    cost: CostModel | None = None,
    seed: int = 0,
) -> list[ArcPoint]:
    """Jellyfish expansion under the same budgets and cost model."""
    cost = cost or CostModel()
    rng = np.random.default_rng(seed)
    r = k_ports - servers_per_switch
    n0 = stages[0].add_servers
    switches = int(np.ceil(n0 / servers_per_switch))
    cum = (
        switches * cost.switch(k_ports)
        + n0 * cost.cable
        + (switches * r // 2) * cost.cable
    )
    top = jellyfish(switches, k_ports, r, seed=rng, name="jellyfish-arc")
    points = [ArcPoint(0, cum, top.n_servers, switches, normalized_bisection(top))]
    for si, st in enumerate(stages[1:], start=1):
        budget = st.budget
        if st.add_servers:
            add_sw = int(np.ceil(st.add_servers / servers_per_switch))
            for _ in range(add_sw):
                fee = (
                    cost.switch(k_ports)
                    + servers_per_switch * cost.cable
                    + (r // 2) * (cost.cable + cost.rewire)  # splice = 1 move + 1 new
                )
                if budget < fee:
                    break
                budget -= fee
                top = add_switch(top, k_ports, r, rng)
        # remaining budget: capacity-only switches (all ports to network)
        while True:
            fee = (
                cost.switch(k_ports)
                + (k_ports // 2) * (cost.cable + cost.rewire)
            )
            if budget < fee:
                break
            budget -= fee
            top = add_switch(top, k_ports, k_ports, rng)
        top = rewire_free_ports(top, rng)
        cum += st.budget - max(budget, 0.0)
        points.append(
            ArcPoint(si, cum, top.n_servers, top.n_switches, normalized_bisection(top))
        )
    return points
