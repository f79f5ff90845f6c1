"""Carry topologies and path systems across from the reference.

In this system topologies and path systems play the part that weights play
in a model: the state a solve runs on.  These helpers build the port's
objects from the reference's, handed over as dicts of numpy arrays (for
example ``dataclasses.asdict(ps)`` of a ``repro`` ``PathSystem``), so both
solvers can be fed the identical state without the port importing
``repro``.  A simulator ``Workload`` is handed over the same way, and so
are a language model's weights: the reference's stacked
parameter tree (a leading layer dim; the hybrid's ``periods`` / ``tail``)
becomes an ``LM`` with one block per layer in absolute order, and back
(``lm_params_to_numpy``, ``opt_state_to_numpy``).  ``reference_decay`` and
``reference_groups`` read the stacking for the optimizer.
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

__all__ = ["lm_params_from_numpy", "lm_params_to_numpy", "opt_state_to_numpy",
           "path_system_from_numpy", "reference_decay", "reference_groups",
           "topology_from_numpy", "workload_from_numpy"]


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
#: The port's per-layer parameters; the reference stacks each of them over
#: its layers, so its leaf has one more dim.
_STACKED = "blocks."


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
                leaves[f"{_STACKED}{first + i * stride}.{name}"] = arr[i]

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


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _lm_tree(cfg, leaves: dict) -> dict:
    """The inverse of ``_lm_leaves``: ``{port parameter name: array}`` as
    the reference's tree, per-layer leaves stacked over their layers."""
    tree, per_layer = {}, {}
    for name, arr in leaves.items():
        if name.startswith(_STACKED):
            layer, rest = name[len(_STACKED):].split(".", 1)
            per_layer.setdefault(int(layer), {})[rest] = arr
        else:
            tree[name] = arr

    def stack(layers) -> dict:
        names = per_layer[layers[0]]
        return _nest({n: np.stack([per_layer[i][n] for i in layers])
                      for n in names})

    if cfg.family == "rglru_hybrid":
        period = len(_PERIOD_PARTS)
        n_periods = cfg.n_layers // (cfg.attn_period or 3)
        tree["periods"] = {
            part: stack(range(j, period * n_periods, period))
            for j, part in enumerate(_PERIOD_PARTS)}
        if cfg.n_layers > period * n_periods:
            tree["tail"] = stack(range(period * n_periods, cfg.n_layers))
    else:
        tree["layers"] = stack(range(cfg.n_layers))
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_to_numpy(model) -> dict:
    """The inverse of ``lm_params_from_numpy``: the ``LM``'s weights as the
    reference's parameter tree of numpy arrays (stacked leaves; bfloat16
    read as float32, since numpy has no bfloat16)."""
    return _lm_tree(model.cfg, {n: _numpy(p)
                                for n, p in model.named_parameters()})


def opt_state_to_numpy(model, opt) -> dict:
    """AdamW's state (``optim.OptState``, keyed by the model's parameter
    names) in the reference's layout: ``{"step", "mu", "nu"}`` with ``mu``
    and ``nu`` as ``lm_params_to_numpy`` gives the parameters."""
    def tree(moments: dict) -> dict:
        return _lm_tree(model.cfg, {n: _numpy(t) for n, t in moments.items()})

    return {"step": _numpy(opt.step), "mu": tree(opt.mu), "nu": tree(opt.nu)}


def reference_decay(model) -> dict:
    """``{name: decayed}`` for AdamW by the reference's rule, a rank of 2 or
    more, read on the reference's leaf: a per-layer parameter is stacked
    there, so its rank is one more than the port's.  (A reference quirk
    the port keeps: every per-layer norm weight and bias is decayed, and
    only the top-level 1-D ``final_norm`` is not.)"""
    return {n: p.dim() + n.startswith(_STACKED) >= 2
            for n, p in model.named_parameters()}


def reference_groups(model) -> list:
    """The port's parameter names grouped by the reference's leaves, each
    group in the order of the leaf's leading (layer) dim: one name for a
    top-level leaf, one per layer for a stacked one.  Concatenating a
    group's flattened tensors gives the reference leaf's flattened values
    (``optim.ef_roundtrip`` blocks its int8 compression that way)."""
    names = {n: np.array(n, dtype=object) for n, _ in model.named_parameters()}
    tree = _lm_tree(model.cfg, names)
    out = []

    def walk(node):
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            else:
                out.append([str(n) for n in np.atleast_1d(v)])

    walk(tree)
    return out
