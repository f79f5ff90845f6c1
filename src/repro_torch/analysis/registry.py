"""Solver entry-point registry of the port: what the IR auditor runs.

The port of ``repro/analysis/registry.py``.  The reference registers its
module-level jits with ``@solver_jit``; the port has no jits.  Its
counterparts are the functions that carry a solver's loop body or launch a
kernel, and each registers at its definition site:

    @solver_entry(spec="_ir_cases_mw_steps")
    def _mw_steps(fused, seg_norm, carry, ...): ...

The registry is the one enumeration both consumers read:

- :mod:`repro_torch.analysis.irlint` runs each entry's cases under a
  ``TorchDispatchMode`` and checks the aten ops they dispatch (JF101-JF105);
- :mod:`repro_torch.analysis.retrace` lists the solver entries for the
  RT-1 check.

``spec`` names a module-level function of the entry's module (resolved
lazily, so case functions cost nothing at import) that returns a list of
:class:`AuditCase`.  Each case's ``make(device)`` builds tiny seeded
arguments on ``device``: the cases run in eager mode, so data-dependent
loops really run.  Dispatch wrappers (``kernels/ops.py``) register with
``kind="wrapper"``: the auditor runs their cases, but the host-sync rule
(JF104) and the RT-1 view cover solver entries only.

Rule JF100 (:mod:`repro_torch.analysis.irlint`) makes the registration
mechanical: an AST scan of the solver directories fails the audit for a
function that reaches a kernel wrapper and is neither registered nor
exempted by a pragma, and every one of the reference's registered entries
must map to a registered port entry (:data:`REFERENCE_ENTRIES`).

Pure stdlib (no torch import): the lint CLI and the linter's pragma
validation read :data:`IR_RULES` without loading torch.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Mapping

__all__ = [
    "FOLDED_REASONS",
    "IR_RULES",
    "REFERENCE_ENTRIES",
    "SOLVER_MODULES",
    "AuditCase",
    "SolverEntry",
    "registered_entries",
    "solver_entry",
]

#: Every module that defines (or may grow) registered solver entries.  JF100
#: cross-checks the list against an AST scan of the solver directories.
#: ``core/routing.py`` registers nothing today (host enumeration feeding the
#: solvers) but stays listed, as in the reference, so the first kernel
#: caller someone adds there must register or JF100 fires.
SOLVER_MODULES = (
    "repro_torch.core.flow",
    "repro_torch.core.routing",
    "repro_torch.core.mptcp",
    "repro_torch.sim.engine",
    "repro_torch.sim.events",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.admission",
    "repro_torch.kernels.congestion",
    "repro_torch.kernels.fanin",
    "repro_torch.kernels.minplus",
    "repro_torch.kernels.power",
)

#: The audit rules (``python -m repro_torch.analysis ir``; INVARIANTS.md is
#: the catalog).  The ids are the reference's, read at the dispatch level.
IR_RULES = {
    "JF100": "every function that reaches a kernel wrapper is registered "
    "for audit",
    "JF101": "no float contraction outside the _fold_sum halving tree",
    "JF102": "no accumulating scatter under the gather backend",
    "JF103": "no float64 or complex tensor in a solver case",
    "JF104": "no host-sync op in a solver entry's case",
    "JF105": "aten op count, FLOPs and bytes within ir_budget_torch.json",
}

#: The reference's registered entries (``repro.analysis.registry
#: .registered_entries()``), each mapped to its port counterpart, or to
#: ``None`` where the port folded the function inline
#: (:data:`FOLDED_REASONS` says where and why).
REFERENCE_ENTRIES = {
    "repro.core.flow._mw_window": "repro_torch.core.flow._mw_steps",
    "repro.core.flow._mw_window_batch": "repro_torch.core.flow._mw_steps",
    "repro.core.flow._mw_final": "repro_torch.core.flow._mw_final",
    "repro.core.flow._mw_final_batch": "repro_torch.core.flow._mw_final",
    "repro.core.flow._mw_carry_init": None,
    "repro.core.flow._mw_carry_init_batch": None,
    "repro.core.mptcp._pf_solve": "repro_torch.core.mptcp._pf_solve",
    "repro.sim.engine._waterfill_jit": "repro_torch.sim.engine._waterfill_core",
    "repro.sim.engine._sim_scan": "repro_torch.sim.engine._run_steps",
    "repro.kernels.congestion.congestion_pallas":
        "repro_torch.kernels.congestion.congestion",
    "repro.kernels.congestion._congestion_pallas_batch":
        "repro_torch.kernels.congestion.congestion",
    "repro.kernels.minplus.minplus_pallas":
        "repro_torch.kernels.minplus.minplus",
    "repro.kernels.admission.admission_pallas":
        "repro_torch.kernels.admission.admission",
    "repro.kernels.power.matmul_pallas": "repro_torch.kernels.power.matmul",
    "repro.kernels.ops.congestion": "repro_torch.kernels.ops.congestion",
    "repro.kernels.ops.congestion_loads":
        "repro_torch.kernels.ops.congestion_loads",
    "repro.kernels.ref.congestion_ref":
        "repro_torch.kernels.congestion.congestion_ref",
    "repro.kernels.ref.minplus_ref": "repro_torch.kernels.minplus.minplus_ref",
    "repro.kernels.ref.matmul_ref": "repro_torch.kernels.power.matmul_ref",
}

FOLDED_REASONS = {
    "repro.core.flow._mw_carry_init": (
        "folded into core.flow._seq_setup with the rest of a sequential "
        "solve's set-up: one seg_norm of the start split and the carry's "
        "four tensors, run once a solve before the loop; it reaches no "
        "kernel, and the seg_norm it runs is the one _mw_steps' cases run"),
    "repro.core.flow._mw_carry_init_batch": (
        "folded into core.flow._batch_setup, as the sequential one into "
        "_seq_setup"),
}


@dataclasses.dataclass(frozen=True)
class AuditCase:
    """One concrete tiny-size invocation of a solver entry.

    ``make(device)`` returns ``(args, kwargs)`` on ``device``: tensors with
    tiny seeded contents (never all zeros: the case runs, and its
    data-dependent loops must run too) and Python values.

    ``backend`` scopes JF102 (it constrains the ``gather`` backend only).
    ``exempt`` maps rule ids to the recorded reason a rule deliberately
    does not apply.  ``budget`` opts the case into the JF105 footprint
    snapshot (CPU runs only).  ``kernels`` names the launch counters
    (``repro_torch.kernels.launch_counts()`` keys) the case must move on a
    CUDA device: the kernels launch through ``ctypes``, unseen by the
    dispatcher, so the counters are the evidence a case reached them.
    """

    label: str
    make: Callable[[Any], tuple[tuple, dict]]
    backend: str | None = None
    exempt: Mapping[str, str] = dataclasses.field(default_factory=dict)
    budget: bool = True
    kernels: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    """A registered entry, addressed by dotted names.

    Names (not objects) are stored so resolution happens at call time via
    ``getattr``: a test monkeypatching the module attribute sees its
    stand-in picked up.
    """

    module: str
    attr: str
    kind: str = "solver"  # "solver" | "wrapper" (a dispatch wrapper)
    spec: str | None = None  # module-level fn -> list[AuditCase]

    @property
    def name(self) -> str:
        return f"{self.module}.{self.attr}"

    def resolve(self) -> Any:
        return getattr(importlib.import_module(self.module), self.attr)

    def cases(self) -> list[AuditCase]:
        if self.spec is None:
            return []
        fn = getattr(importlib.import_module(self.module), self.spec)
        return list(fn())


_REGISTRY: dict[str, SolverEntry] = {}


def solver_entry(spec: str | None = None, kind: str = "solver"):
    """Decorator registering a module-level solver entry (or wrapper).

    The function passes through untouched.  ``spec`` names a function in
    the same module returning the entry's :class:`AuditCase` list (resolved
    lazily, so it may be defined later in the file).
    """
    if kind not in ("solver", "wrapper"):
        raise ValueError(f"unknown solver entry kind: {kind!r}")

    def register(fn):
        module, attr = fn.__module__, fn.__name__
        _REGISTRY[f"{module}.{attr}"] = SolverEntry(
            module=module, attr=attr, kind=kind, spec=spec
        )
        return fn

    return register


def registered_entries() -> dict[str, SolverEntry]:
    """``{dotted name: SolverEntry}`` after importing every solver module,
    sorted by name so audit output and budget files are stably ordered."""
    for mod in SOLVER_MODULES:
        importlib.import_module(mod)
    return dict(sorted(_REGISTRY.items()))
