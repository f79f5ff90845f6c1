"""Runtime contract checks of the port (numpy only)."""

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
    "set_check_enabled",
]
