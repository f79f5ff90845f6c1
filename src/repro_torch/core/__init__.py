"""The port's core library: the capacity path of the Jellyfish paper.

Public API re-exports of the ported modules (topology, traffic, routing,
flow, bisection, metrics).  The other reference modules (expansion,
failures, MPTCP, the batch path-system builder, the other topology
families) are not ported yet.
"""

from .bisection import (
    bollobas_bound,
    kernighan_lin_bisection,
    max_feasible,
    normalized_bisection,
    spectral_lambda2,
    spectral_lower_bound,
    speculative_max_feasible,
)
from .fattree import fattree, fattree_equipment
from .flow import (
    FlowResult,
    PathSystemBatch,
    lp_concurrent_flow,
    mw_concurrent_flow,
    mw_concurrent_flow_batch,
    throughput,
)
from .jellyfish import jellyfish, jellyfish_heterogeneous, rrg
from .metrics import (
    INT16_INF,
    apsp_hops,
    apsp_hops_blocked,
    bollobas_diameter_bound,
    hops_to_f32,
    hops_to_int16,
    path_stats,
    PathStats,
)
from .routing import (
    PathSystem,
    build_path_system,
    k_shortest_paths,
    set_admission_backend,
    set_apsp_backend,
)
from .topology import (
    Topology,
    adj_to_edges,
    edge_delta,
    edge_fingerprint,
    edges_to_adj,
)
from .traffic import (
    Commodities,
    all_to_all_traffic,
    extend_server_permutation,
    permutation_commodities,
    random_permutation_traffic,
    random_server_permutation,
    union_commodities,
)

__all__ = [
    "Topology", "adj_to_edges", "edges_to_adj", "edge_delta", "edge_fingerprint",
    "jellyfish", "jellyfish_heterogeneous", "rrg",
    "fattree", "fattree_equipment",
    "apsp_hops", "apsp_hops_blocked", "INT16_INF", "hops_to_int16",
    "hops_to_f32", "path_stats", "PathStats", "bollobas_diameter_bound",
    "bollobas_bound", "spectral_lambda2", "spectral_lower_bound",
    "kernighan_lin_bisection", "normalized_bisection",
    "max_feasible", "speculative_max_feasible",
    "Commodities", "random_permutation_traffic", "all_to_all_traffic",
    "random_server_permutation", "extend_server_permutation",
    "permutation_commodities", "union_commodities",
    "PathSystem", "build_path_system", "k_shortest_paths",
    "set_apsp_backend", "set_admission_backend",
    "FlowResult", "PathSystemBatch", "mw_concurrent_flow",
    "mw_concurrent_flow_batch", "lp_concurrent_flow", "throughput",
]
