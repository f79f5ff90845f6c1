"""The port's core library: the Jellyfish paper's computations on torch.

Public API re-exports of the ported modules: topology and the Jellyfish,
fat-tree and leaf-spine Clos families, the paper's comparison families
(small-world datacenters, degree-diameter graphs, locality-restricted
Jellyfish with its cable plan), traffic, routing (with the cross-instance
batch build, ECMP path systems and delta re-routing after a topology
change), the build pipeline, flow (path and edge LPs, MW), fluid MPTCP,
bisection, metrics, incremental expansion, failures and repairs, and the
LEGUP expansion-economics arcs.  Every module of ``repro.core`` is ported.
"""

from .buildpipe import pipeline_enabled, set_build_pipeline, stream_builds
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
from .degree_diameter import CATALOG as DD_CATALOG
from .degree_diameter import degree_diameter_graph
from .expansion import add_switch, expand_to, remove_switch, rewire_free_ports
from .failures import fail_links, fail_switches, heal_links
from .fattree import fattree, fattree_equipment
from .flow import (
    FlowResult,
    PathSystemBatch,
    lp_concurrent_flow,
    lp_edge_concurrent_flow,
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
from .mptcp import MptcpResult, mptcp_throughput
from .placement import CablePlan, localized_jellyfish, plan_cables
from .routing import (
    PathSystem,
    build_path_system,
    build_path_system_batch,
    ecmp_path_system,
    k_shortest_paths,
    set_admission_backend,
    set_apsp_backend,
    update_path_system,
)
from .swdc import swdc_hex3d, swdc_ring, swdc_torus2d
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
    "swdc_ring", "swdc_torus2d", "swdc_hex3d",
    "DD_CATALOG", "degree_diameter_graph",
    "CostModel", "ExpansionStage", "legup_arc", "jellyfish_arc",
    "apsp_hops", "apsp_hops_blocked", "INT16_INF", "hops_to_int16",
    "hops_to_f32", "path_stats", "PathStats", "bollobas_diameter_bound",
    "bollobas_bound", "spectral_lambda2", "spectral_lower_bound",
    "kernighan_lin_bisection", "normalized_bisection",
    "max_feasible", "speculative_max_feasible",
    "Commodities", "random_permutation_traffic", "all_to_all_traffic",
    "random_server_permutation", "extend_server_permutation",
    "permutation_commodities", "union_commodities",
    "PathSystem", "build_path_system", "build_path_system_batch",
    "ecmp_path_system", "k_shortest_paths",
    "update_path_system", "set_apsp_backend", "set_admission_backend",
    "pipeline_enabled", "set_build_pipeline", "stream_builds",
    "FlowResult", "PathSystemBatch", "mw_concurrent_flow",
    "mw_concurrent_flow_batch", "lp_concurrent_flow",
    "lp_edge_concurrent_flow", "throughput",
    "MptcpResult", "mptcp_throughput",
    "fail_links", "fail_switches", "heal_links",
    "CablePlan", "localized_jellyfish", "plan_cables",
]
