"""repro_torch.sim: batched flow-level dynamic-traffic engine (paper §3,
Table 1, Fig 9), on torch.

The port of ``repro.sim``.  ECMP gives a random graph too little path
diversity (Table 1), and restoring fat-tree-level throughput needs
k-shortest-path routing with MPTCP on top (Fig 9).  This package exercises
routings under *time-varying* traffic — flow arrivals and departures,
diurnal load, elephant/mice mixes, permutation churn:

* ``ecmp``      — equal-cost path sets (``routing.ecmp_path_system``) and
  the deterministic integer-mixing flow hash ECMP uses to pin flows to
  paths;
* ``engine``    — the fluid flow-level simulator, batched over topology
  seeds/instances through ``core.flow.PathSystemBatch`` with per-instance
  masks; its max-min waterfilling inner loop uses the MW solver's
  congestion backends' load half (``gather`` fan-in tables, or the
  congestion kernel on CUDA);
* ``workloads`` — scenario generators (steady Poisson, diurnal wave,
  elephant/mice, permutation churn);
* ``telemetry`` — FCT percentiles, per-link utilization, throughput
  timeseries reductions, and the Table-1 / Fig-9 path-diversity counters.

Live fault injection (``events``), the tenant-churn and failure-schedule
generators and ``telemetry.event_summary`` wait for their port.  Import
validates the ``REPRO_SIM_MAX_STEPS`` / ``REPRO_SIM_MAX_BATCH`` caps
(through ``repro_torch.env``).
"""

from .ecmp import (
    ecmp_group_sizes,
    ecmp_path_system,
    fattree_ecmp_check,
    flow_hash,
    hash_select_rows,
)
from .engine import (
    POLICIES,
    SIM_MAX_BATCH,
    SIM_MAX_STEPS,
    SimConfig,
    SimResult,
    draw_arrivals,
    simulate,
    waterfill_rates,
)
from .telemetry import (
    fct_percentiles,
    link_utilization,
    path_diversity,
    per_commodity_goodput,
    per_commodity_throughput,
    ranked_normalized_throughput,
    steady_state_throughput,
)
from .workloads import (
    Workload,
    diurnal_wave,
    elephant_mice,
    permutation_churn,
    steady_poisson,
)

__all__ = [
    "ecmp_path_system",
    "ecmp_group_sizes",
    "fattree_ecmp_check",
    "flow_hash",
    "hash_select_rows",
    "POLICIES",
    "SIM_MAX_STEPS",
    "SIM_MAX_BATCH",
    "SimConfig",
    "SimResult",
    "draw_arrivals",
    "simulate",
    "waterfill_rates",
    "Workload",
    "steady_poisson",
    "diurnal_wave",
    "elephant_mice",
    "permutation_churn",
    "fct_percentiles",
    "link_utilization",
    "path_diversity",
    "per_commodity_goodput",
    "per_commodity_throughput",
    "ranked_normalized_throughput",
    "steady_state_throughput",
]
