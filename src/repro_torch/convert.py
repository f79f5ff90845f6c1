"""Carry topologies and path systems across from the reference.

In this system topologies and path systems play the part that weights play
in a model: the state a solve runs on.  These helpers build the port's
objects from the reference's, handed over as dicts of numpy arrays (for
example ``dataclasses.asdict(ps)`` of a ``repro`` ``PathSystem``), so both
solvers can be fed the identical state without the port importing
``repro``.  A simulator ``Workload`` is handed over the same way, and so
are a language model's weights: the reference's stacked
parameter tree (a leading layer dim; the hybrid's ``periods`` / ``tail``)
becomes an ``LM`` with one block per layer in absolute order.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .core.routing import PathSystem
from .core.topology import Topology
from .models import LM
from .sim.workloads import Workload

__all__ = ["lm_params_from_numpy",
           "path_system_from_numpy", "topology_from_numpy",
           "workload_from_numpy"]


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


def workload_from_numpy(fields: dict) -> Workload:
    """A port sim ``Workload`` from the fields of a reference one (``rate``,
    the size mixture and the optional demand epochs); arrays are copied."""
    return _build(Workload, fields)


#: Blocks of one hybrid period, in layer order (the reference's period tree).
_PERIOD_PARTS = ("rec_a", "rec_b", "attn")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lm_leaves(cfg, tree: dict) -> dict:
    """The reference's parameter tree as ``{port parameter name: array}``;
    stacked leaves are split per layer into ``blocks.<layer>.<path>``."""
    tree = dict(tree)
    leaves = {k: tree.pop(k) for k in ("embed", "final_norm", "lm_head")
              if k in tree}

    def unstack(sub, first: int, stride: int, where: str):
        if not isinstance(sub, dict):
            raise ValueError(f"{where}: expected a dict of stacked leaves")
        for name, arr in _flatten(sub).items():
            for i in range(np.shape(arr)[0]):
                leaves[f"blocks.{first + i * stride}.{name}"] = arr[i]

    if "layers" in tree:
        unstack(tree.pop("layers"), 0, 1, "layers")
    if "periods" in tree:
        periods = dict(tree.pop("periods"))
        for j, part in enumerate(_PERIOD_PARTS):
            if part in periods:
                unstack(periods.pop(part), j, len(_PERIOD_PARTS),
                        f"periods.{part}")
        if periods:
            raise ValueError(f"unknown leaves periods.{sorted(periods)}")
    if "tail" in tree:
        n_periods = cfg.n_layers // (cfg.attn_period or 3)
        unstack(tree.pop("tail"), len(_PERIOD_PARTS) * n_periods, 1, "tail")
    if tree:
        raise ValueError(f"unknown leaves {sorted(tree)}")
    return leaves


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "f" and a.dtype != np.float64:
        a = a.astype(np.float32)  # also reads bfloat16 arrays
    return torch.tensor(a, device=device).to(dtype)


def lm_params_from_numpy(cfg, tree: dict, dtype=torch.float32,
                         device="cuda"):
    """An ``LM`` of ``cfg`` holding the reference's weights ``tree`` (its
    ``init_params`` output as numpy arrays, e.g. ``jax.tree_util.tree_map(
    np.asarray, params)``), cast to ``dtype`` on ``device``.  Raises on a
    leaf the port does not have, on a missing one and on a shape
    mismatch."""
    model = LM(cfg, seed=None, dtype=dtype, device=device)
    leaves = _lm_leaves(cfg, tree)
    params = dict(model.named_parameters())
    unknown = sorted(set(leaves) - set(params))
    missing = sorted(set(params) - set(leaves))
    if unknown or missing:
        raise ValueError(f"{cfg.name}: unknown leaves {unknown}, "
                         f"missing leaves {missing}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(np.shape(leaves[name])) != tuple(p.shape):
                raise ValueError(f"{cfg.name}: {name} has shape "
                                 f"{np.shape(leaves[name])}, the port's "
                                 f"{tuple(p.shape)}")
            p.copy_(_tensor(leaves[name], dtype, p.device))
    return model
