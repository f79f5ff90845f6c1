"""Best-known degree-diameter benchmark graphs (paper §4.1, Fig 2).

The paper benchmarks Jellyfish against the best-known graphs from the
degree-diameter problem (Comellas & Delorme catalog), the most extreme being
the Hoffman–Singleton graph — the largest degree-diameter graph *known to be
optimal* (N=50, degree 7, diameter 2), against which Jellyfish still reaches
~86% throughput.

We use the named graphs available in networkx as the catalog.  Each entry is
(name, N, network_degree); ``build`` returns a Topology with a chosen port
count so that servers can be attached exactly as in the paper's methodology
(same switching equipment as the Jellyfish it is compared against).

Port copy of ``repro/core/degree_diameter.py``, carried over unchanged apart
from this note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import networkx as nx
import numpy as np

from .topology import Topology

__all__ = ["CATALOG", "degree_diameter_graph"]


def _petersen():
    return nx.petersen_graph()


def _heawood():
    return nx.heawood_graph()


def _pappus():
    return nx.pappus_graph()


def _desargues():
    return nx.desargues_graph()


def _mcgee():
    # (3,7)-cage, 24 nodes — LCF notation
    return nx.LCF_graph(24, [12, 7, -7], 8)


def _tutte_coxeter():
    # (3,8)-cage (Levi graph), 30 nodes
    return nx.LCF_graph(30, [-13, -9, 7, -7, 9, 13], 5)


def _chvatal():
    return nx.chvatal_graph()  # 12 nodes, degree 4, diameter 2


def _icosahedral():
    return nx.icosahedral_graph()  # 12 nodes, degree 5, diameter 3

def _robertson():
    # (4,5)-cage, 19 nodes, degree 4, diameter 3
    edges = [(0,1),(1,2),(2,3),(3,4),(4,5),(5,6),(6,7),(7,8),(8,9),(9,10),
             (10,11),(11,12),(12,13),(13,14),(14,15),(15,16),(16,17),(17,18),
             (18,0),(0,4),(4,9),(9,13),(13,17),(17,2),(2,6),(6,11),(11,15),
             (15,0),(1,8),(8,16),(16,5),(5,12),(12,1),(3,10),(10,18),(18,7),
             (7,14),(14,3)]
    g = nx.Graph(edges)
    return g


def _hoffman_singleton():
    return nx.hoffman_singleton_graph()


# name -> (constructor, N, degree, diameter)
CATALOG = {
    "petersen": (_petersen, 10, 3, 2),
    "heawood": (_heawood, 14, 3, 3),
    "pappus": (_pappus, 18, 3, 4),
    "desargues": (_desargues, 20, 3, 5),
    "mcgee": (_mcgee, 24, 3, 4),
    "tutte-coxeter": (_tutte_coxeter, 30, 3, 4),
    "chvatal": (_chvatal, 12, 4, 2),
    "icosahedral": (_icosahedral, 12, 5, 3),
    "robertson": (_robertson, 19, 4, 3),
    "hoffman-singleton": (_hoffman_singleton, 50, 7, 2),
}


def degree_diameter_graph(name: str, k_ports: int) -> Topology:
    """Build a catalog graph as a Topology with ``k_ports`` ports per switch."""
    ctor, n, deg, diam = CATALOG[name]
    g = ctor()
    assert g.number_of_nodes() == n, name
    degs = {d for _, d in g.degree()}
    assert degs == {deg}, (name, degs)
    if k_ports < deg:
        raise ValueError(f"{name} needs k >= {deg}")
    edges = [(min(u, v), max(u, v)) for u, v in g.edges()]
    top = Topology.regular(
        n, k_ports, deg, edges, name=f"dd-{name}(N={n},deg={deg})",
        kind="degree-diameter", diameter=diam,
    )
    top.validate()
    return top
