"""Validated registry for the ``REPRO_*`` variables the port reads.

The port's copy of ``repro/env.py``, cut to the knobs on its path: read each
knob ONCE at import, and make a malformed value fail loudly at startup with a
``ValueError`` naming the variable.  A variable that the reference also reads
keeps its name here only where the port accepts exactly the same values, so
one environment configures both packages consistently.  A port-only value
goes under a ``REPRO_TORCH_*`` name: both registries validate their whole
table at import, and a value one of them does not know would fail the other.

Importing this module validates the ENTIRE registry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

__all__ = [
    "ADMISSION_BACKENDS",
    "APSP_BACKENDS",
    "EnvSpec",
    "SPECS",
    "is_set",
    "read",
    "validate_all",
]

#: APSP backend choices: the reference's exact set (``REPRO_APSP_BACKEND``).
APSP_BACKENDS = ("auto", "dense", "blocked", "minplus", "minplus_blocked")

#: Admissibility-prune backends of the port's path enumerator.  ``kernel``
#: routes the prune through ``repro_torch.kernels.admission`` on the build's
#: device; ``numpy`` keeps it in the host enumerator; ``auto`` (the default)
#: takes ``kernel`` on a CUDA build and ``numpy`` on a CPU build.  All give
#: the same mask (exact comparisons only).
ADMISSION_BACKENDS = ("auto", "numpy", "kernel")


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """One registered variable: how to parse it and what it defaults to."""

    name: str
    parse: Callable[[str, str], Any]  # (name, raw) -> value, raises ValueError
    default: Any
    doc: str

    def read(self) -> Any:
        raw = os.environ.get(self.name, "")
        if not raw.strip():
            return self.default
        return self.parse(self.name, raw.strip())


def _parse_int(minimum: int | None = None, maximum: int | None = None,
               hint: str = ""):
    def parse(name: str, raw: str) -> int:
        try:
            value = int(raw)
        except ValueError:
            raise ValueError(
                f"{name}={raw!r}: expected an integer{hint}"
            ) from None
        if minimum is not None and value < minimum:
            raise ValueError(
                f"{name}={value}: expected an integer >= {minimum}{hint}"
            )
        if maximum is not None and value > maximum:
            raise ValueError(
                f"{name}={value}: expected an integer <= {maximum}{hint}"
            )
        return value

    return parse


def _parse_flag(name: str, raw: str) -> bool:
    try:
        return bool(int(raw))
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: expected an integer flag (0 or 1)"
        ) from None


def _parse_choice(choices: tuple[str, ...]):
    def parse(name: str, raw: str) -> str:
        value = raw.strip().lower()
        if value not in choices:
            raise ValueError(
                f"{name}={value!r}: expected one of {choices}"
            )
        return value

    return parse


def _parse_str(name: str, raw: str) -> str:
    return raw


SPECS: dict[str, EnvSpec] = {
    spec.name: spec
    for spec in (
        EnvSpec(
            "REPRO_APSP_BACKEND",
            _parse_choice(APSP_BACKENDS),
            "auto",
            "Initial APSP backend (see repro_torch.core.routing."
            "set_apsp_backend).",
        ),
        EnvSpec(
            "REPRO_ROUTE_TILE_BYTES",
            _parse_int(minimum=1 << 20, maximum=1 << 40,
                       hint=" (float32 tile budget in bytes, 1 MiB..1 TiB)"),
            256 << 20,
            "Float32 working-tile budget for the sharded path enumerator.",
        ),
        EnvSpec(
            "REPRO_TORCH_ADMISSION_BACKEND",
            _parse_choice(ADMISSION_BACKENDS),
            "auto",
            "Admissibility-prune backend for the port's path enumerator "
            "(see repro_torch.core.routing.set_admission_backend).",
        ),
        EnvSpec(
            "REPRO_BUILD_PIPELINE",
            _parse_flag,
            True,
            "Route sweeps through the pipelined/batched path-system build "
            "(0 falls back to sequential per-instance builds).",
        ),
        EnvSpec(
            "REPRO_LP_PATH_LIMIT",
            _parse_int(minimum=0, hint=" (paths at or below it go to the "
                                       "exact LP in throughput())"),
            20000,
            "throughput()'s LP-vs-MW cutoff in path variables.",
        ),
        EnvSpec(
            "REPRO_SIM_MAX_STEPS",
            _parse_int(minimum=1, hint=" (hard cap on the batched sim scan)"),
            200_000,
            "Hard cap on a single sim scan's step count.",
        ),
        EnvSpec(
            "REPRO_SIM_MAX_BATCH",
            _parse_int(minimum=1, hint=" (hard cap on the batched sim scan)"),
            1024,
            "Hard cap on the instance batch width of one sim scan.",
        ),
        EnvSpec(
            "REPRO_SIM_EVENT_LAG",
            _parse_int(minimum=0, hint=" (blackhole/reconvergence steps "
                                       "after a path-killing event)"),
            2,
            "Default detection + reconvergence lag (in sim steps) during "
            "which flows whose path died blackhole their traffic "
            "(see repro_torch.sim.events.simulate_events).",
        ),
        EnvSpec(
            "REPRO_SIM_EVENT_MAX_SEG",
            _parse_int(minimum=0, hint=" (forced sim segment split length "
                                       "in steps; 0 disables)"),
            0,
            "Force simulate_events to split runs into segments of at most "
            "this many steps even between events (0 = split only at "
            "events; the CT-segment parity contract must hold either way).",
        ),
        EnvSpec(
            "REPRO_CHECK",
            _parse_flag,
            False,
            "Enable the runtime contract validators "
            "(repro_torch.analysis.contracts) at solver boundaries.",
        ),
        EnvSpec(
            "REPRO_TRACE",
            _parse_flag,
            False,
            "Enable the repro_torch.obs span tracer (host-boundary spans).",
        ),
        EnvSpec(
            "REPRO_TRACE_OUT",
            _parse_str,
            "artifacts/obs",
            "Output directory for trace artifacts.",
        ),
    )
}


def read(name: str) -> Any:
    """Parsed + validated value of a registered variable (or its default)."""
    return SPECS[name].read()


def is_set(name: str) -> bool:
    """True when the variable is present and non-empty in the environment."""
    if name not in SPECS:
        raise KeyError(f"{name} is not a registered REPRO_* variable")
    return bool(os.environ.get(name, "").strip())


def validate_all() -> None:
    """Parse every registered variable; raise on the first malformed one."""
    for spec in SPECS.values():
        spec.read()


validate_all()
