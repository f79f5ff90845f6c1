"""Carry topologies and path systems across from the reference.

In this system topologies and path systems play the part that weights play
in a model: the state a solve runs on.  These helpers build the port's
objects from the reference's, handed over as dicts of numpy arrays (for
example ``dataclasses.asdict(ps)`` of a ``repro`` ``PathSystem``), so both
solvers can be fed the identical state without the port importing
``repro``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .core.routing import PathSystem
from .core.topology import Topology

__all__ = ["path_system_from_numpy", "topology_from_numpy"]


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def _build(cls, fields: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {unknown}")
    return cls(**{k: _copy(v) for k, v in fields.items()})


def topology_from_numpy(fields: dict) -> Topology:
    """A port ``Topology`` from the fields of a reference one (``n_switches``,
    ``edges``, ``ports``, ``net_degree``, optionally ``name`` and ``meta``);
    arrays are copied, and ``meta`` (which holds the delta records of
    ``core.expansion`` / ``core.failures``) is copied down to its lists, so
    the two topologies share no state."""
    fields = dict(fields)
    if "meta" in fields:
        fields["meta"] = copy.deepcopy(fields["meta"])
    return _build(Topology, fields)


def path_system_from_numpy(fields: dict) -> PathSystem:
    """A port ``PathSystem`` from the fields of a reference one; arrays are
    copied, so the two objects share no memory."""
    return _build(PathSystem, fields)
