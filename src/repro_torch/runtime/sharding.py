"""Sharding rules: logical tensor dims -> mesh axes, for params and activations.

The port of ``repro/runtime/sharding.py`` over ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.  Mesh axes: ``('pod', 'data', 'model')``
multi-pod, ``('data', 'model')`` single-pod.  Strategy (MaxText-style TP x
FSDP), as in the reference:

* params: tensor-parallel on ``model`` over heads/ffn/vocab; ZeRO-3/FSDP on
  ``(pod, data)`` over the complementary dim.  Optimizer state inherits.
* activations: batch on ``(pod, data)``; heads/ffn/vocab on ``model``;
  sequence unsharded by default, sequence-parallel on ``(pod, data)`` when
  the per-device batch would be < 1 (long-context decode / huge prefill).

Models never mention mesh axes: they call ``shd.act(x, "btd")`` with a
one-char-per-dim logical signature:

  b=batch  s/t=sequence  d=d_model  h=heads  k=kv-heads  f=ffn  v=vocab
  e=expert  c=capacity  .=replicated

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim: None, a mesh axis name, or a tuple of names (major first).
``placements`` turns it into DTensor placements, one per mesh dim: the
counterpart of a ``NamedSharding``.  ``act`` is the counterpart of
``with_sharding_constraint``: a ``redistribute`` to the fitted placements.
A ``Sharder`` with ``mesh=None`` is a no-op.

``Sharder.local`` runs a function on each rank's shards (the pattern of
``torch.distributed.tensor.experimental.local_map``) where DTensor has no
sharding rule for an op the port uses or would gather what the reference
keeps sharded.  The model files name, at each call, which ops run there.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

__all__ = ["PARAM_RULES", "Sharder", "Sharding", "act", "as_dtensor",
           "axis_names", "axis_sizes", "batch_axes", "cache_shardings",
           "fit_spec", "leaf_spec", "local_numel", "local_span",
           "param_shardings", "placements", "run_local"]

Axis = Any  # str | tuple[str, ...] | None


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s dim names, or a duck-typed
    mesh's ``axis_names`` (the reference's ``Mesh`` has both forms)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def placements(spec, mesh) -> tuple:
    """DTensor placements of a spec: ``Shard(d)`` on every mesh dim that
    tensor dim d names, ``Replicate()`` on the others.  A tuple entry shards
    one tensor dim over several mesh dims, major first, which must be the
    mesh's own order (as every spec of these rules is)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_span(size: int, mesh, placements_, dim: int) -> tuple[int, int]:
    """(offset, extent) of this rank's shard along tensor dim ``dim`` of
    extent ``size`` (even shards, as every fitted spec gives): the mesh
    dims that shard ``dim``, major first, index the shard."""
    coord = mesh.get_coordinate()
    n, index = size, 0
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            n //= k
            index = index * k + coord[i]
    return index * n, n


def local_numel(shape, mesh, placements_) -> int:
    """Elements of this rank's shard of a tensor of ``shape``."""
    total = 1
    for d, size in enumerate(shape):
        total *= local_span(size, mesh, placements_, d)[1]
    return total


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor is a replicated value
    (each rank holds the same)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the counterpart of a ``NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, t: torch.Tensor) -> DTensor:
        """``t`` (the full value, the same on every rank) as a DTensor of
        this sharding: each rank keeps its shard, nothing is sent."""
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


class _GradAs(torch.autograd.Function):
    """Identity whose gradient is brought to ``pl``."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


@dataclasses.dataclass
class Sharder:
    mesh: Any = None
    seq_shard: bool = False  # sequence parallelism for batch<dp cases
    dp_only: bool = False  # no TP anywhere: batch shards over ALL axes
    # (rwkv-family, §Perf R2: the model axis would otherwise idle)

    def _axes(self) -> dict[str, Axis]:
        if self.mesh is None:
            return {}
        names = axis_names(self.mesh)
        batch = tuple(
            a for a in (("pod", "data", "model") if self.dp_only
                        else ("pod", "data")) if a in names
        ) or None
        # dp_only: the model axis carries batch, so nothing else may use it
        model = None if self.dp_only else ("model" if "model" in names else None)
        seq = batch if self.seq_shard else None
        return {
            "b": None if self.seq_shard else batch,
            "s": seq,
            "t": seq,
            "S": model,  # context parallelism: sequence on the model axis
            "T": model,  # Megatron-style sequence-parallel residual stream
            "d": None,
            "h": model,
            "k": model,
            "f": model,
            "v": model,
            "e": None,
            "c": None,
            ".": None,
        }

    def spec(self, sig: str) -> tuple:
        table = self._axes()
        return tuple(table.get(ch) for ch in sig)

    def act(self, x: torch.Tensor, sig: str) -> torch.Tensor:
        """Sharding constraint from a logical signature.  Axes that do not
        divide the dim are dropped (an uneven sharding would pad; better to
        replicate).  As the transpose of ``with_sharding_constraint`` does,
        the constraint holds for the gradient too: it reaches ``x`` through
        the same placements (DTensor would otherwise pick the gradient's
        placements op by op)."""
        if self.mesh is None:
            return x
        assert len(sig) == x.ndim, (sig, x.shape)
        pl = placements(fit_spec(self.spec(sig), x.shape, self.mesh),
                        self.mesh)
        y = as_dtensor(x, self.mesh).redistribute(self.mesh, pl)
        return _GradAs.apply(y, pl) if y.requires_grad else y

    def divisible(self, n: int, axis: str = "model") -> bool:
        if self.mesh is None or axis not in axis_names(self.mesh):
            return False
        return n % axis_sizes(self.mesh)[axis] == 0

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 without a mesh or axis)."""
        if self.mesh is None or axis not in axis_names(self.mesh):
            return 0
        return self.mesh.get_local_rank(axis)

    def local(self, fn, args, sigs, out_sigs, partial: str = ""):
        """``fn`` on each rank's shards.  Each tensor argument with a
        signature is brought to its fitted sharding and passed as the local
        shard; an argument whose signature is None passes as it is (a
        DTensor as its full value).  Each output of ``fn`` comes back as a
        DTensor sharded by its signature in ``out_sigs``, each of whose
        dims takes the axes its letter got on the inputs (a letter no input
        has is replicated); over the axes the letters in ``partial`` got,
        the outputs are partial sums (``fn`` contracted a dim sharded
        there).  ``fn`` must compute each output shard from the input
        shards alone, or communicate itself.

        Gradients: an input replicated over a mesh dim that shards an output
        or holds its partial sums gets its gradient summed over that dim
        (each rank used it for its own part).  Without a mesh,
        ``fn(*args)``."""
        if self.mesh is None:
            return fn(*args)
        mesh = self.mesh
        names = axis_names(mesh)
        table: dict[str, Axis] = {}
        prepared = []
        for a, sig in zip(args, sigs):
            if sig is None or not isinstance(a, torch.Tensor):
                prepared.append((a, None))
                continue
            assert len(sig) == a.ndim, (sig, a.shape)
            spec = fit_spec(self.spec(sig), a.shape, mesh)
            for ch, ax in zip(sig, spec):
                table.setdefault(ch, ax)
            prepared.append((as_dtensor(a, mesh).redistribute(
                mesh, placements(spec, mesh)), spec))
        summed = {names.index(a) for ch in partial for a in (
            (table.get(ch),) if isinstance(table.get(ch), str)
            else tuple(table.get(ch) or ()))}
        single = isinstance(out_sigs, str)
        out_pl = [[Partial() if i in summed else p for i, p in enumerate(
                   placements(tuple(table.get(ch) for ch in sig), mesh))]
                  for sig in ([out_sigs] if single else out_sigs)]
        used = {i for pl in out_pl for i, p in enumerate(pl)
                if not isinstance(p, Replicate)}
        ins = []
        for a, spec in prepared:
            if spec is None:
                ins.append(a.full_tensor() if isinstance(a, DTensor) else a)
                continue
            grad = [Partial() if isinstance(p, Replicate) and i in used
                    else p for i, p in enumerate(a.placements)]
            ins.append(a.to_local(grad_placements=grad))
        res = fn(*ins)
        outs = [res] if single else list(res)
        wrapped = [o if not isinstance(o, torch.Tensor) else
                   DTensor.from_local(o, mesh, pl, run_check=False)
                   for o, pl in zip(outs, out_pl)]
        return wrapped[0] if single else tuple(wrapped)


def act(shd, x: torch.Tensor, sig: str) -> torch.Tensor:
    """``shd.act(x, sig)``, or ``x`` when there is no Sharder."""
    return x if shd is None else shd.act(x, sig)


def run_local(shd, fn, args, sigs, out_sigs, partial: str = ""):
    """``shd.local(fn, args, sigs, out_sigs, partial)``, or ``fn(*args)``
    when there is no Sharder."""
    if shd is None:
        return fn(*args)
    return shd.local(fn, args, sigs, out_sigs, partial)


# --------------------------------------------------------------------------- #
# Parameter sharding rules: (path regex, signature by ndim)
# Signatures use the same one-char language; leading "L" (layer-stack dim) and
# other structural dims map to ".".  First matching rule wins.  The paths and
# ranks are the reference's leaves (``convert.reference_leaves``).
# --------------------------------------------------------------------------- #

# FSDP goes on the complementary big dim ("D" below = d_model rows -> fsdp).
# "D" char: shard on (pod, data); lowercase letters as in Sharder.

PARAM_RULES: list[tuple[str, dict[int, str]]] = [
    (r"embed", {2: "vD"}),  # (V, D): vocab on model, d on fsdp
    (r"lm_head", {2: "Dv"}),  # (D, V)
    # rwkv: FSDP-only, NO tensor parallelism (§Perf R2).  The mixers bounce
    # between full-width (B,S,D) elementwise work and per-head state math
    # ~20x per layer; TP-sharding the projections of a 2048-wide model over
    # a 16-way axis costs a (B,S,D)-sized f32 collective at every boundary
    # (measured 14.2 s/step).  These rules MUST precede the attention rules
    # (rwkv_wk would otherwise match r"wk$").
    (r"rwkv_w[rkvgo]$", {3: ".D."}),  # (L, D, D)
    (r"cm_wk$", {3: ".D."}),
    (r"cm_wv$", {3: "..D"}),
    (r"cm_wr$", {3: ".D."}),
    (r"(maa_w1|decay_w1)$", {3: ".D."}),
    (r"(wq|wk|wv|w_qkv)$", {3: ".Dh"}),  # (L, D, H*hd)
    (r"(wq|wk|wv)_b$", {2: ".h"}),  # bias (L, H*hd)
    (r"wo$", {3: ".hD"}),  # (L, H*hd, D)
    (r"(w1|w3)$", {3: ".Df"}),  # (L, D, F)
    (r"w2$", {3: ".fD"}),  # (L, F, D)
    (r"(we1|we3)$", {4: "..Df"}),  # (L, E, D, F)
    (r"we2$", {4: "..fD"}),  # (L, E, F, D)
    (r"router$", {3: ".D."}),  # (L, D, E)
    (r"(shared_w1|shared_w3)$", {3: ".Df"}),
    (r"shared_w2$", {3: ".fD"}),
    (r"(lru_in|lru_gate_x|lru_gate_a)$", {3: ".Df", 4: "..Df"}),
    (r"lru_out$", {3: ".fD", 4: "..fD"}),
]


def _spec_from_sig(sig: str, mesh) -> tuple:
    names = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in names) or None
    model = "model" if "model" in names else None
    table = {
        "D": batch,  # FSDP dim
        "v": model,
        "h": model,
        "f": model,
        "k": model,
        "d": None,
        ".": None,
    }
    return tuple(table.get(ch) for ch in sig)


def fit_spec(spec, shape: tuple[int, ...], mesh) -> tuple:
    """Adapt a spec to the array: for tuple axes keep the longest PREFIX
    whose product divides the dim; drop single axes that do not divide
    (shards must be even)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        kept = []
        total = 1
        for a in axes:
            if shape[i] % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    # pad spec to rank
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def leaf_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The reference's spec of the parameter leaf ``path`` of ``shape``
    (first matching rule, fitted; replicated when none matches), padded to
    the leaf's rank."""
    for pat, by_ndim in PARAM_RULES:
        if re.search(pat, path) and len(shape) in by_ndim:
            return fit_spec(_spec_from_sig(by_ndim[len(shape)], mesh), shape,
                            mesh)
    return (None,) * len(shape)


def param_shardings(model, mesh) -> dict:
    """``{parameter name: Sharding}`` by PARAM_RULES, read on each port
    parameter's reference leaf: a per-layer tensor is one slice of a leaf
    stacked over the layers, so the rule is chosen by the stacked leaf's
    path and rank, fitted to its shape, and its leading (layer) entry, which
    no rule shards, is dropped."""
    from ..convert import reference_leaves

    out = {}
    for name, (path, shape, stacked) in reference_leaves(model).items():
        spec = leaf_spec(path, shape, mesh)
        if stacked:
            assert spec[0] is None, (path, spec)
            spec = spec[1:]
        out[name] = Sharding(mesh, spec)
    return out


# --------------------------------------------------------------------------- #
# batch and cache rules (the reference keeps them in launch/steps.py, which
# re-exports these; the models place the caches prefill makes)
# --------------------------------------------------------------------------- #


def batch_axes(mesh, batch_size: int, all_axes: bool = False) -> Axis:
    """The longest prefix of ``(pod, data[, model])`` whose product divides
    the batch."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    cand = ("pod", "data", "model") if all_axes else ("pod", "data")
    axes = []
    total = 1
    for a in cand:
        if a in names and batch_size % (total * sizes[a]) == 0:
            axes.append(a)
            total *= sizes[a]
        elif a in names:
            break
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def cache_shardings(caches, mesh, batch_size: int) -> list:
    """One ``{leaf: Sharding}`` per layer of the port's caches.  KV caches
    (B, slots, KVH, hd): batch + kv-heads sharding, falling back to
    sharding the slots when KVH does not divide the model axis; recurrent
    states: the state width on 'model'.  The reference's leaves carry a
    leading layer dim, which no rule shards; the port's per-layer leaves
    drop it."""
    ba = batch_axes(mesh, batch_size)
    model = "model" if "model" in axis_names(mesh) else None
    msize = axis_sizes(mesh)[model] if model else 1

    def one(name: str, shape: tuple) -> tuple:
        if name in ("k", "v"):
            if model and shape[2] % msize == 0:
                spec = (ba, None, model, None)
            else:
                spec = (ba, model, None, None)
        elif name == "wkv":  # (B, H, hd, hd)
            spec = (ba, model, None, None)
        elif name in ("shift_tm", "shift_cm"):
            spec = (ba, None)
        elif name == "h":  # (B, Dr)
            spec = (ba, model)
        elif name == "conv":  # (B, 3, Dr)
            spec = (ba, None, model)
        else:  # abs_pos and anything unknown: replicated
            return (None,) * len(shape)
        return fit_spec(spec, shape, mesh)

    return [{n: Sharding(mesh, one(n, tuple(t.shape))) for n, t in c.items()}
            for c in caches]
