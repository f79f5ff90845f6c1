"""Fused congestion: edge loads and path prices from one pass over B.

The inner loop of the MW solver needs, per iteration, BOTH

    loads[e]  = sum_p rates[p]  * B[p, e]        (= B^T r)
    costs[p]  = sum_e prices[e] * B[p, e]        (= B  w)

where B is the {0,1} path x directed-slot incidence, by far the largest
operand.  :func:`congestion` computes the pair for a single (P, S)
incidence or for a stacked (Bt, P, S) one (one independent product per
batch member).  On a CUDA tensor it launches the hand-written kernel in
``csrc/congestion.cu`` (see the note there: one read of B, no atomics,
sums in an order fixed by position, so a member of a zero-padded batch
equals the unpadded call bit for bit); on a CPU tensor it uses the plain
version :func:`congestion_ref`.

Replaces ``repro/kernels/congestion.py`` (``congestion_pallas`` and its
batched form) and ``repro/kernels/ref.py::congestion_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "check_congestion_dtype",
    "congestion",
    "congestion_ref",
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
    "congestion_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
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


def congestion_ref(incidence, rates, prices) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ``(B^T r, B w)``, unfused; rank 2 or stacked rank 3."""
    b, r, w = check_congestion_dtype(incidence, rates, prices)
    if b.ndim == 3:
        loads = torch.bmm(r.unsqueeze(1), b).squeeze(1)
        costs = torch.bmm(b, w.unsqueeze(2)).squeeze(2)
        return loads, costs
    return r @ b, b @ w


def congestion(incidence, rates, prices) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(loads, costs) = (B^T r, B w)``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    Shapes: (P, S), (P,), (S,) -> (S,), (P,); or stacked (Bt, P, S),
    (Bt, P), (Bt, S) -> (Bt, S), (Bt, P).
    """
    b, r, w = check_congestion_dtype(incidence, rates, prices)
    if b.device.type == "cpu":
        return congestion_ref(b, r, w)
    return _congestion_cuda(b, r, w)


def _congestion_cuda(b, r, w):
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
                costs.data_ptr(), partial.data_ptr(), Bt, P, S, stream,
            )
        _build.check_launch(err, "congestion kernel")
        if single:
            launches += 1
        else:
            batch_launches += 1
    if single:
        return loads[0], costs[0]
    return loads, costs
