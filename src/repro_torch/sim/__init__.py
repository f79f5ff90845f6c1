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
* ``events``    — live fault injection (§4.3): ``simulate_events`` splits
  the step loop at scheduled failures / repairs / expansions, repairs
  routing with ``update_path_system``, and migrates the live carry via
  ``row_map`` — surviving flows keep state bit-exactly, disrupted flows
  blackhole for a detection lag then re-select;
* ``workloads`` — scenario generators (steady Poisson, diurnal wave,
  elephant/mice, permutation churn, MTBF/MTTR failure schedules, tenant
  arrival/departure riding ``core.expansion`` +
  ``routing.update_path_system``);
* ``telemetry`` — FCT percentiles, per-link utilization, throughput
  timeseries reductions, per-event retention/disruption summaries, and the
  Table-1 / Fig-9 path-diversity counters.

Import validates the ``REPRO_SIM_MAX_STEPS`` / ``REPRO_SIM_MAX_BATCH`` caps
and the ``REPRO_SIM_EVENT_LAG`` / ``REPRO_SIM_EVENT_MAX_SEG`` defaults
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
from .events import (
    EVENT_KINDS,
    Event,
    EventSimResult,
    simulate_events,
    validate_schedule,
)
from .telemetry import (
    event_summary,
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
    poisson_failure_schedule,
    run_tenant_churn,
    steady_poisson,
    tenant_churn_segments,
)

__all__ = [
    "Event",
    "EVENT_KINDS",
    "EventSimResult",
    "event_summary",
    "poisson_failure_schedule",
    "simulate_events",
    "validate_schedule",
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
    "tenant_churn_segments",
    "run_tenant_churn",
    "fct_percentiles",
    "link_utilization",
    "path_diversity",
    "per_commodity_goodput",
    "per_commodity_throughput",
    "ranked_normalized_throughput",
    "steady_state_throughput",
]
