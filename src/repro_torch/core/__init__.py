"""The port's core library: the Jellyfish paper's computations on torch.

Public API re-exports of the ported modules: topology and the Jellyfish,
fat-tree and leaf-spine Clos families, traffic, routing (with delta
re-routing after a topology change), flow, bisection, metrics, incremental
expansion and failures, and the LEGUP expansion-economics arcs.  Not ported
yet: MPTCP, the batch path-system builder (``build_path_system_batch``,
``buildpipe``), ECMP path systems, and the other topology families
(small-world, degree-diameter, placement).
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
from .clos import ClosSpec, build_clos
from .expansion import add_switch, expand_to, remove_switch, rewire_free_ports
from .failures import fail_links, fail_switches
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
from .legup import CostModel, ExpansionStage, jellyfish_arc, legup_arc
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
    update_path_system,
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
    "add_switch", "remove_switch", "rewire_free_ports", "expand_to",
    "fattree", "fattree_equipment",
    "ClosSpec", "build_clos",
    "CostModel", "ExpansionStage", "legup_arc", "jellyfish_arc",
    "apsp_hops", "apsp_hops_blocked", "INT16_INF", "hops_to_int16",
    "hops_to_f32", "path_stats", "PathStats", "bollobas_diameter_bound",
    "bollobas_bound", "spectral_lambda2", "spectral_lower_bound",
    "kernighan_lin_bisection", "normalized_bisection",
    "max_feasible", "speculative_max_feasible",
    "Commodities", "random_permutation_traffic", "all_to_all_traffic",
    "random_server_permutation", "extend_server_permutation",
    "permutation_commodities", "union_commodities",
    "PathSystem", "build_path_system", "k_shortest_paths",
    "update_path_system", "set_apsp_backend", "set_admission_backend",
    "FlowResult", "PathSystemBatch", "mw_concurrent_flow",
    "mw_concurrent_flow_batch", "lp_concurrent_flow", "throughput",
    "fail_links", "fail_switches",
]
