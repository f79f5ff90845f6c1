"""Fused congestion: edge loads and path prices from one pass over B.

The inner loop of the MW solver needs, per iteration, BOTH

    loads[e]  = sum_p rates[p]  * B[p, e]        (= B^T r)
    costs[p]  = sum_e prices[e] * B[p, e]        (= B  w)

where B is the {0,1} path x directed-slot incidence, by far the largest
operand.  :func:`congestion` computes the pair for a single (P, S)
incidence or for a stacked (Bt, P, S) one (one independent product per
batch member), optionally over each member's real extent (``extents``).
On a CUDA tensor it launches the hand-written kernel in
``csrc/congestion.cu`` (see the note there: one read of B, no atomics,
sums in an order fixed by position, so a member of a stacked call equals
the single call on its unpadded incidence bit for bit); on a CPU tensor it
uses the plain version :func:`congestion_ref`.

Replaces ``repro/kernels/congestion.py`` (``congestion_pallas`` and its
batched form) and ``repro/kernels/ref.py::congestion_ref``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..analysis.registry import AuditCase, solver_entry

__all__ = [
    "check_congestion_dtype",
    "check_extents",
    "congestion",
    "congestion_ref",
    "vector_width",
    "batch_launches",
    "launches",
]

#: Launches of the CUDA kernel since import (or the last reset), for a
#: single (P, S) incidence (``launches``, the reference's congestion_kernel)
#: and for a stacked (Bt, P, S) one (``batch_launches``, the reference's
#: congestion_batch_kernel).  Both run the same kernel.
launches = 0
batch_launches = 0

_SIGS = {
    "congestion_rows_per_band": [],
    "congestion_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def check_congestion_dtype(incidence, rates, prices) -> tuple:
    """Validate operand dtypes and cast them to float32.

    The incidence is {0,1} and may arrive as bool, integer or float; all
    cast exactly.  Complex operands would be silently truncated by the cast,
    so they are rejected.
    """
    out = []
    for label, x in (("incidence", incidence), ("rates", rates),
                     ("prices", prices)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"congestion {label} must be a torch.Tensor")
        if x.is_complex():
            raise ValueError(
                f"congestion {label} must be bool/integer/floating "
                f"(got {x.dtype}): the kernel computes in float32"
            )
        out.append(x.to(torch.float32))
    b, r, w = out
    if b.ndim not in (2, 3) or r.ndim != b.ndim - 1 or w.ndim != b.ndim - 1:
        raise ValueError(
            f"congestion shapes: incidence (P, S) with rates (P,) and prices "
            f"(S,), or (Bt, P, S) with (Bt, P) and (Bt, S); got "
            f"{tuple(b.shape)}, {tuple(r.shape)}, {tuple(w.shape)}"
        )
    if r.shape[-1] != b.shape[-2] or w.shape[-1] != b.shape[-1] or (
        b.ndim == 3 and not (r.shape[0] == w.shape[0] == b.shape[0])
    ):
        raise ValueError(
            f"congestion shape mismatch: incidence {tuple(b.shape)}, rates "
            f"{tuple(r.shape)}, prices {tuple(w.shape)}"
        )
    return b, r, w


def check_extents(extents, shape) -> tuple[np.ndarray, np.ndarray] | None:
    """Validate ``extents=(rows, cols)`` against an incidence ``shape`` and
    return them as two host int32 arrays of one entry per member (``None``
    for ``None``: the full shape).

    For a rank-2 (P, S) incidence each is an int; for a stacked (Bt, P, S)
    one each is a (Bt,) sequence, numpy array or CPU tensor of integers,
    with ``0 <= rows[b] <= P`` and ``0 <= cols[b] <= S``.  Extents are host
    values: reading them from the card would stall every call.
    """
    if extents is None:
        return None
    if len(extents) != 2:
        raise ValueError("congestion extents must be a pair (rows, cols)")
    P, S = shape[-2:]
    n = shape[0] if len(shape) == 3 else None
    out = []
    for label, x, hi in (("rows", extents[0], P), ("cols", extents[1], S)):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise ValueError(
                    f"congestion extents ({label}) must be host values, got "
                    f"a tensor on {x.device}")
            x = x.numpy()
        a = np.asarray(x)
        if a.dtype.kind not in "iu" or a.shape != (() if n is None else (n,)):
            want = "an int" if n is None else f"({n},) integers"
            raise ValueError(
                f"congestion extents ({label}) must be {want} for incidence "
                f"shape {tuple(shape)}; got {a.dtype} of shape {a.shape}")
        if a.size and (a.min() < 0 or a.max() > hi):
            raise ValueError(
                f"congestion extents ({label}) must lie in [0, {hi}]; got "
                f"{a.tolist()}")
        out.append(np.ascontiguousarray(a.reshape(-1), dtype=np.int32))
    return out[0], out[1]


@solver_entry(spec="_ir_cases_congestion_ref")
def congestion_ref(incidence, rates, prices,
                   extents=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ``(B^T r, B w)``, unfused; rank 2 or stacked rank 3.

    With ``extents=(rows, cols)``, member b is
    ``(B[b, :P_b, :S_b]^T r[b, :P_b], B[b, :P_b, :S_b] w[b, :S_b])`` with
    exact zeros beyond ``S_b`` and ``P_b``."""
    b, r, w = check_congestion_dtype(incidence, rates, prices)
    ext = check_extents(extents, b.shape)
    if ext is None:
        if b.ndim == 3:
            loads = torch.bmm(r.unsqueeze(1), b).squeeze(1)
            costs = torch.bmm(b, w.unsqueeze(2)).squeeze(2)
            return loads, costs
        return r @ b, b @ w
    single = b.ndim == 2
    if single:
        b, r, w = b.unsqueeze(0), r.unsqueeze(0), w.unsqueeze(0)
    loads = torch.zeros(b.shape[0], b.shape[2], dtype=torch.float32,
                        device=b.device)
    costs = torch.zeros(b.shape[:2], dtype=torch.float32, device=b.device)
    for i, (p, s) in enumerate(zip(ext[0].tolist(), ext[1].tolist())):
        blk = b[i, :p, :s]
        loads[i, :s] = r[i, :p] @ blk
        costs[i, :p] = blk @ w[i, :s]
    if single:
        return loads[0], costs[0]
    return loads, costs


@solver_entry(spec="_ir_cases_congestion")
def congestion(incidence, rates, prices,
               extents=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(loads, costs) = (B^T r, B w)``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    Shapes: (P, S), (P,), (S,) -> (S,), (P,); or stacked (Bt, P, S),
    (Bt, P), (Bt, S) -> (Bt, S), (Bt, P).

    ``extents=(rows, cols)`` (see :func:`check_extents`) restricts member b
    to its real block ``B[b, :P_b, :S_b]``: the kernel reads no row at or
    past ``P_b`` and no column at or past ``S_b``, and the outputs there
    are exact zeros.  ``None`` means the full shape.

    In the batched MW solver this is exact, not an approximation.  Its
    stack does hold non-zero padding: each member's padding sentinel hits
    column ``S_b`` from the padded rows and from real rows shorter than the
    envelope.  But the solver's prices there are exactly 0 (a masked
    softmax times zero inverse capacity), and its rates on padded rows are
    0 (the dummy commodity has zero demand), so every real output is the
    same sum with or without the padding, and ``loads * inv_cap`` is 0 on
    padded slots either way.  And because the kernel's sums run in an
    order fixed by absolute position, a member of a call with extents
    equals the single call on its unpadded (P_b, S_b) incidence bit for
    bit.
    """
    b, r, w = check_congestion_dtype(incidence, rates, prices)
    if b.device.type == "cpu":
        return congestion_ref(b, r, w, extents)
    return _congestion_cuda(b, r, w, check_extents(extents, b.shape))


def vector_width(b: torch.Tensor) -> int:
    """Floats per copy of B in the kernel: 4 (16 bytes) when the rows are a
    multiple of 4 floats long and B's address is 16-byte aligned, else 2
    (8 bytes) or 1."""
    S = b.shape[-1]
    for v in (4, 2):
        if S % v == 0 and b.data_ptr() % (4 * v) == 0:
            return v
    return 1


def _congestion_cuda(b, r, w, ext):
    global launches, batch_launches
    if b.device.type != "cuda":
        raise ValueError(f"congestion: unsupported device {b.device}")
    if not (r.device == w.device == b.device):
        raise ValueError("congestion operands must be on one device")
    if not (b.is_contiguous() and r.is_contiguous() and w.is_contiguous()):
        raise ValueError("congestion operands must be contiguous")
    single = b.ndim == 2
    if single:
        b, r, w = b.unsqueeze(0), r.unsqueeze(0), w.unsqueeze(0)
    Bt, P, S = b.shape
    if max(Bt, P, S) >= 2 ** 31:
        raise ValueError(f"congestion shape {tuple(b.shape)} exceeds int32")
    if ext is None:
        ext = (np.full(Bt, P, np.int32), np.full(Bt, S, np.int32))
    loads = torch.empty((Bt, S), dtype=torch.float32, device=b.device)
    costs = torch.empty((Bt, P), dtype=torch.float32, device=b.device)
    if P == 0 or S == 0 or Bt == 0:
        loads.zero_()
        costs.zero_()
    else:
        lib = _build.library("congestion", _SIGS)
        rows = lib.congestion_rows_per_band()
        partial = torch.empty(
            (Bt, (P + rows - 1) // rows, S), dtype=torch.float32,
            device=b.device,
        )
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            err = lib.congestion_launch(
                b.data_ptr(), r.data_ptr(), w.data_ptr(), loads.data_ptr(),
                costs.data_ptr(), partial.data_ptr(), ext[0].ctypes.data,
                ext[1].ctypes.data, Bt, P, S, vector_width(b), stream,
            )
        _build.check_launch(err, "congestion kernel")
        with _build.COUNT_LOCK:
            if single:
                launches += 1
            else:
                batch_launches += 1
    if single:
        return loads[0], costs[0]
    return loads, costs


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

_IR_MXU_EXEMPT = {
    "JF101": "the fused congestion kernel IS the dense-incidence product "
    "(the plain matrix products on the CPU); its reassociation drift "
    "against gather is the documented dense-backend contract (CG-3)",
}


def _ir_operands(dev, shape, seed: int = 0) -> tuple:
    """Seeded {0,1} incidence of ``shape`` (P, S) or (Bt, P, S) with
    positive rates and prices on ``dev``."""
    rng = np.random.default_rng(seed)
    inc = (rng.random(shape) < 0.3).astype(np.float32)
    rates = rng.uniform(0.5, 1.5, shape[:-1]).astype(np.float32)
    prices = rng.uniform(0.5, 1.5, shape[:-2] + shape[-1:]).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (inc, rates, prices))


def _ir_cases_congestion():
    def rank2(dev):
        return _ir_operands(dev, (24, 40)), {}

    def rank3(dev):
        return _ir_operands(dev, (2, 24, 40)), {
            "extents": (np.array([24, 17]), np.array([40, 29]))}

    return [
        AuditCase(label="rank2", make=rank2, exempt=_IR_MXU_EXEMPT,
                  budget=False, kernels=("congestion",)),
        AuditCase(label="rank3-extents", make=rank3, exempt=_IR_MXU_EXEMPT,
                  budget=False, kernels=("congestion_batch",)),
    ]


def _ir_cases_congestion_ref():
    return [AuditCase(label="rank2",
                      make=lambda dev: (_ir_operands(dev, (24, 40)), {}),
                      exempt=_IR_MXU_EXEMPT)]
