"""Per-rank op statistics of a traced step.

The port's counterpart of ``repro/roofline/hlo_stats.py``.  The reference
reads the optimized HLO of the per-device SPMD program (with while-loop
trip counts).  The port has no HLO: the dry run (``launch.dryrun``) runs
the step on fake tensors over a fake process group, as rank 0, and
``OpCounter`` counts each op as it executes on rank 0's local shards:

- FLOPs of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / convolution:
  2 x the result's elements x the contracted extent K (matrix-unit work;
  elementwise flops are left to the bytes term, as in the reference);
- HBM bytes: the result and tensor operands of every op that materializes
  a tensor (views and empty allocations skipped): the reference's "every
  materialized buffer crosses HBM once" approximation;
- collectives: the ``_c10d_functional`` (and ``_dtensor``) ops that
  DTensor and the port's local regions emit, by kind, payload and group
  size, whose wire bytes follow the ring models in ``analysis``.  On a CPU
  mesh (the dry run's) DTensor emits an all-to-all as an all-gather and a
  chunk, which is counted as the all-to-all it stands for;
- peak bytes: the most bytes of live tensors at any op (``base_bytes``,
  what existed before counting began, plus every tensor an op has made
  and that is still alive).

Every loop of the step runs (microbatches, layers, attention chunks), so
nothing is scaled by trip counts.  A dispatch mode entered around DTensor
code sees each op at its global shape (as ``FlopCounterMode`` does), so
``OpCounter`` declines ops on DTensors (``NotImplemented``): DTensor then
runs them and the counter sees the local ops it emits.  DTensor's
sharding propagation also runs ops on global-shape fake tensors to infer
output shapes; those are recognised by their caller and skipped.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from .analysis import CollectiveOp

__all__ = ["OpCounter", "OpStats", "tensor_bytes"]

aten = torch.ops.aten

# the operand whose last dim is the contracted extent K (None: a
# convolution, whose K is one output element's weights)
_CONTRACTIONS = {
    aten.mm.default: 0,
    aten.addmm.default: 1,
    aten.bmm.default: 0,
    aten.baddbmm.default: 1,
    aten.convolution.default: None,
}
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default}
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# the result is the payload of these (the gathered / scattered tensor)
_BY_RESULT = {"all-gather", "reduce-scatter"}


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _called_from(filename: str, function: str | None = None,
                 depth: int = 40) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith(filename) and (
                function is None or f.f_code.co_name == function):
            return True
        f = f.f_back
        depth -= 1
    return False


def _group_size(group) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):
        group = _resolve_process_group(group)
    return group.size()


def _contraction_flops(func, args, out) -> float:
    i = _CONTRACTIONS[func]
    k = args[1][0].numel() if i is None else args[i].shape[-1]
    return 2.0 * out.numel() * k


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    peak_bytes: int = 0
    n_ops: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)

    def collective_ops(self) -> list[CollectiveOp]:
        return list(self.collectives.values())

    @property
    def wire_bytes(self) -> float:
        return sum(c.wire_bytes() * c.count for c in self.collectives.values())


class OpCounter(TorchDispatchMode):
    """Counts the local ops run under it into ``self.stats`` (see the
    module docstring).  ``base_bytes``: live bytes before it starts."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.stats = OpStats(peak_bytes=base_bytes)
        self._live_bytes = base_bytes
        self._storages: dict[int, weakref.ref] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self._live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = weakref.ref(
            st, lambda _, k=key, n=nbytes: self._free(k, n))
        self._live_bytes += nbytes
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live_bytes)

    def _collective(self, func, args, outs) -> None:
        name = func.__name__.split(".")[0]
        if name == "wait_tensor":  # returns its input: counted at its start
            return
        kind = _KINDS.get(name)
        ins = list(_tensors(args))
        stand_in = (kind == "all-gather" and _called_from(
            "_collective_utils.py", "shard_dim_alltoall"))
        if stand_in:
            # DTensor replaces an all-to-all by an all-gather and a chunk on
            # CPU meshes (gloo has none): counted as the all-to-all, and its
            # gathered temporary (a card never makes it) left out
            kind = "all-to-all"
        if kind is None:
            return
        payload = sum(map(tensor_bytes, outs if kind in _BY_RESULT else ins))
        key = (kind, payload, _group_size(args[-1]))
        if key in self.stats.collectives:
            self.stats.collectives[key].count += 1
        else:
            self.stats.collectives[key] = CollectiveOp(*key)
        if not stand_in:
            for o in outs:
                self._track(o)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _called_from("_sharding_prop.py"):
            return out
        outs = list(_tensors([out]))
        if not outs:  # a query (prim.device, sizes): no tensor is made
            return out
        st = self.stats
        st.n_ops += 1
        if func.namespace in ("_c10d_functional", "_dtensor"):
            self._collective(func, args, outs)
            return out
        if func in _CONTRACTIONS:
            st.flops += _contraction_flops(func, args, outs[0])
        is_view = any(r.alias_info is not None and not r.alias_info.is_write
                      for r in func._schema.returns)
        if not is_view and func not in _NO_TRAFFIC:
            st.hbm_bytes += sum(map(tensor_bytes, outs))
            st.hbm_bytes += sum(map(tensor_bytes, _tensors(args)))
        if not is_view:
            for o in outs:
                self._track(o)
        return out
