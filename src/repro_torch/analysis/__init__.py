"""The port's determinism toolbox: linter, contracts, registry, auditor.

- :mod:`repro_torch.analysis.linter` — pure-stdlib AST linter (rules
  JF001-JF006), ``python -m repro_torch.analysis``.
- :mod:`repro_torch.analysis.contracts` — runtime checks of path systems,
  batches and simulator state (numpy only).
- :mod:`repro_torch.analysis.registry` — the ``@solver_entry`` registry the
  auditor and the compile tracer enumerate (pure stdlib).
- :mod:`repro_torch.analysis.irlint` — the dispatch-level auditor (rules
  JF100-JF105), ``python -m repro_torch.analysis ir``; imported lazily,
  since it imports torch and the lint CLI must not.
- :mod:`repro_torch.analysis.retrace` — the compile tracer (RT-1: a second
  same-bucket run builds no kernel); lazy as well.
"""

from .contracts import (
    ContractViolation,
    check_built_batch,
    check_carry_migration,
    check_hop_matrix,
    check_path_system,
    check_path_system_batch,
    check_sim_state,
    checks_enabled,
    set_check_enabled,
)

__all__ = [
    "ContractViolation",
    "check_built_batch",
    "check_carry_migration",
    "check_hop_matrix",
    "check_path_system",
    "check_path_system_batch",
    "check_sim_state",
    "checks_enabled",
    "irlint",
    "registry",
    "retrace",
    "set_check_enabled",
]


def __getattr__(name: str):
    # lazy: irlint and retrace import torch; the lint CLI must not.
    # registry is stdlib but joins them for symmetry of access.
    if name in ("irlint", "registry", "retrace"):
        import importlib

        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")
