"""Ordered fan-in loads: ``B^T r`` from the fan-in table, no incidence.

The loads-only half of the congestion product (the simulator's waterfill
consumes no path costs) sums, for every directed slot, the rates of the
path rows whose hops cross it:

    loads[b, s] = rates[b, t_0 // L] + rates[b, t_1 // L] + ...

over the slot's fan-in row ``t_0 < t_1 < ...`` of flat path-hop positions
(``t = p * L + l``), LEFT TO RIGHT.  That is the order of the reference's
scatter-add and of ``core.flow._ordered_fan_in_sum``, whose arithmetic the
plain version :func:`fan_in_loads_ref` repeats.

The table is ``PathSystemBatch.slot_gather`` transposed to (Bt, D, S), or
(D, S) when every member routes over one table (``fan_in_table``), int32,
each row's positions first and the sentinel ``P * L`` after.
:func:`fan_in_loads` launches the kernel of ``csrc/fanin.cu`` on CUDA
tensors and uses the plain version on CPU tensors; the two are equal bit for
bit.  The kernel replaces no Pallas kernel: the dense
``congestion_batch_kernel`` counterpart stays for the MW solvers, which need
the costs too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..analysis.registry import AuditCase, solver_entry

__all__ = ["check_fan_in", "fan_in_loads", "fan_in_loads_ref",
           "fan_in_table", "launches"]

#: Launches of the CUDA kernel since import (or the last reset).
launches = 0

_SIGS = {
    "fan_in_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def fan_in_table(slot_gather: np.ndarray, device) -> torch.Tensor:
    """A (.., S, D) fan-in table as the (.., D, S) int32 tensor on ``device``
    that both versions read (built once per batch, not per call)."""
    tab = np.ascontiguousarray(np.swapaxes(slot_gather, -1, -2), np.int32)
    return torch.from_numpy(tab).to(device)


def check_fan_in(table, rates, L: int, slots=None) -> np.ndarray | None:
    """Validate the operands; return ``slots`` as a host int32 array of one
    entry per member (``None`` for ``None``: every slot is real).

    ``table`` is (Bt, D, S) or shared (D, S) int32, contiguous; ``rates``
    (Bt, P) float32, contiguous, on the table's device; ``L`` the hop
    columns per path row, with ``P * L`` below 2^31; ``slots`` (Bt,) host
    integers in [0, S], each member's real slot count (slots past it load
    an exact zero; the table holds only sentinels there).
    """
    for label, x, dtype in (("table", table, torch.int32),
                            ("rates", rates, torch.float32)):
        if not isinstance(x, torch.Tensor) or x.dtype != dtype:
            raise ValueError(f"fan_in_loads {label} must be a {dtype} tensor "
                             f"(got {getattr(x, 'dtype', type(x))})")
        if not x.is_contiguous():
            raise ValueError(f"fan_in_loads {label} must be contiguous")
    if table.device != rates.device:
        raise ValueError(f"fan_in_loads operands on {table.device} and "
                         f"{rates.device}: they must share one device")
    if rates.ndim != 2 or table.ndim not in (2, 3) or (
            table.ndim == 3 and table.shape[0] != rates.shape[0]):
        raise ValueError(
            f"fan_in_loads shapes: table (Bt, D, S) or (D, S) with rates "
            f"(Bt, P); got {tuple(table.shape)}, {tuple(rates.shape)}")
    if int(L) < 1 or rates.shape[1] * int(L) >= 2 ** 31:
        raise ValueError(f"fan_in_loads L={L}: need 1 <= L and P * L < 2^31 "
                         f"(P = {rates.shape[1]})")
    if slots is None:
        return None
    if isinstance(slots, torch.Tensor):
        if slots.device.type != "cpu":
            raise ValueError("fan_in_loads slots must be host values, got a "
                             f"tensor on {slots.device}")
        slots = slots.numpy()
    a = np.asarray(slots)
    S = table.shape[-1]
    if a.dtype.kind not in "iu" or a.shape != (rates.shape[0],):
        raise ValueError(f"fan_in_loads slots must be ({rates.shape[0]},) "
                         f"integers; got {a.dtype} of shape {a.shape}")
    if a.size and (a.min() < 0 or a.max() > S):
        raise ValueError(f"fan_in_loads slots must lie in [0, {S}]; got "
                         f"{a.tolist()}")
    return np.ascontiguousarray(a, dtype=np.int32)


@solver_entry(spec="_ir_cases_fan_in_ref")
def fan_in_loads_ref(table, rates, L: int, slots=None) -> torch.Tensor:
    """Plain torch loads: the table's columns gathered from the rates
    repeated ``L`` times with a trailing zero (the sentinel's), accumulated
    one by one, as ``core.flow._ordered_fan_in_sum`` does."""
    check_fan_in(table, rates, L, slots)
    Bt, S = rates.shape[0], table.shape[-1]
    if table.shape[-2] == 0:
        return torch.zeros((Bt, S), dtype=torch.float32, device=rates.device)
    fr = torch.nn.functional.pad(rates.repeat_interleave(int(L), dim=1),
                                 (0, 1))
    acc = None
    for idx in table.unbind(-2):
        v = fr[..., idx] if idx.ndim == 1 else torch.gather(fr, 1, idx)
        acc = v if acc is None else acc + v
    return acc


@solver_entry(spec="_ir_cases_fan_in")
def fan_in_loads(table, rates, L: int, slots=None) -> torch.Tensor:
    """(Bt, S) loads: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors (see :func:`check_fan_in` for the operands)."""
    if rates.device.type == "cpu":
        return fan_in_loads_ref(table, rates, L, slots)
    return _fan_in_cuda(table, rates, int(L), check_fan_in(table, rates, L,
                                                           slots))


def _fan_in_cuda(table, rates, L, slots):
    global launches
    if rates.device.type != "cuda":
        raise ValueError(f"fan_in_loads: unsupported device {rates.device}")
    Bt, P = rates.shape
    D, S = table.shape[-2:]
    if max(Bt, D, S) >= 2 ** 31:
        raise ValueError(f"fan_in_loads table {tuple(table.shape)} exceeds "
                         "int32")
    loads = torch.empty((Bt, S), dtype=torch.float32, device=rates.device)
    if Bt == 0 or S == 0:
        return loads
    if slots is None:
        slots = np.full(Bt, S, np.int32)
    lib = _build.library("fanin", _SIGS)
    with torch.cuda.device(rates.device):
        stream = torch.cuda.current_stream(rates.device).cuda_stream
        err = lib.fan_in_launch(
            table.data_ptr(), rates.data_ptr(), loads.data_ptr(),
            slots.ctypes.data, Bt, int(table.ndim == 2), P, L, S, D, stream)
    _build.check_launch(err, "fan-in kernel")
    with _build.COUNT_LOCK:
        launches += 1
    return loads


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

def _ir_operands(dev, shared: bool = False, seed: int = 0,
                 shape: tuple = (9, 3, 11), slots=(11, 7, 0)) -> tuple:
    """``(table, rates, L, slots)``: a seeded fan-in table of one member per
    entry of ``slots`` (each member's real slot count; a member with none
    has no rows) over ``shape = (P, L, S)``, rows ascending and
    sentinel-padded, D the widest row, and uniform rates."""
    rng = np.random.default_rng(seed)
    P, L, S = shape
    slots = np.asarray(slots)
    Bt = len(slots)
    # member b's hops in [0, slots[b]], the last value meaning none there
    hops = rng.integers(0, slots[:, None, None] + 1, (Bt, P, L))
    hops[hops >= slots[:, None, None]] = S
    flat = hops.reshape(Bt, -1)
    cnt = [np.bincount(f[f < S], minlength=S) for f in flat]
    tab = np.full((Bt, max(int(c.max(initial=0)) for c in cnt), S), P * L,
                  np.int32)
    for b, (f, c) in enumerate(zip(flat, cnt)):
        pos = np.flatnonzero(f < S)
        order = np.argsort(f[pos], kind="stable")
        col = np.arange(len(pos)) - np.repeat(np.cumsum(c) - c, c)
        tab[b, col, f[pos][order]] = pos[order]
    rates = rng.uniform(0.5, 1.5, (Bt, P)).astype(np.float32)
    table = torch.as_tensor(tab[0] if shared else tab, device=dev)
    return table, torch.as_tensor(rates, device=dev), L, slots


def _ir_cases_fan_in():
    return [
        AuditCase(label="stacked", budget=False, kernels=("fan_in_loads",),
                  make=lambda dev: (_ir_operands(dev), {})),
        AuditCase(label="shared", budget=False, kernels=("fan_in_loads",),
                  make=lambda dev: (_ir_operands(dev, shared=True)[:3], {})),
    ]


def _ir_cases_fan_in_ref():
    return [AuditCase(label="stacked", budget=False,
                      make=lambda dev: (_ir_operands(dev), {}))]
