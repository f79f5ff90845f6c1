"""Fused admissibility + simplicity prune for the path enumerator.

Each expansion level of the batched k-shortest-path engine
(``repro_torch.core.routing._batched_round``) decides, for every (frontier
row, candidate neighbour) cell, whether stepping there can still complete
within the pair's length budget AND keeps the prefix simple:

    ok[m, c] = dist(cand[m, c], dst[m]) <= rem[m]
               and cand[m, c] not in pref[m, :]

:func:`admission` launches the kernel of ``csrc/admission.cu`` on CUDA
tensors and uses the plain version :func:`admission_ref` on CPU tensors.
Only exact comparisons are involved, so every backend gives the same mask
and the enumerated path sets never depend on the choice.

Replaces ``repro/kernels/admission.py`` (``admission_pallas`` and
``admission_ref``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..analysis.registry import AuditCase, solver_entry
from ..device import resolve

__all__ = [
    "admission",
    "admission_prune",
    "admission_ref",
    "check_admission_dtype",
    "launches",
]

#: Launches of the CUDA kernel since import (or the last reset).
launches = 0

_SIGS = {
    "admission_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def check_admission_dtype(dvals, rem, cand, pref) -> tuple:
    """Validate the operands: float distances and budgets (half precision
    upcast to float32), int32 candidates and prefixes, matching shapes."""
    out = []
    for label, x in (("dvals", dvals), ("rem", rem)):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            raise ValueError(
                f"admission {label} must be a floating-point tensor "
                f"(got {getattr(x, 'dtype', type(x))})"
            )
        out.append(x.to(torch.float32))
    for label, x in (("cand", cand), ("pref", pref)):
        if not isinstance(x, torch.Tensor) or x.is_floating_point() \
                or x.dtype == torch.bool or x.is_complex():
            raise ValueError(
                f"admission {label} must be an integer tensor "
                f"(got {getattr(x, 'dtype', type(x))})"
            )
        out.append(x.to(torch.int32))
    d, r, c, p = out
    if d.ndim != 2 or c.shape != d.shape or r.shape != (d.shape[0],) \
            or p.ndim != 2 or p.shape[0] != d.shape[0]:
        raise ValueError(
            f"admission shapes: dvals/cand (M, C), rem (M,), pref (M, W); "
            f"got {tuple(d.shape)}, {tuple(c.shape)}, {tuple(r.shape)}, "
            f"{tuple(p.shape)}"
        )
    return d, r, c, p


def admission_ref(dvals, rem, cand, pref) -> torch.Tensor:
    """Plain torch oracle: the same (M, C) bool mask."""
    d, r, c, p = check_admission_dtype(dvals, rem, cand, pref)
    ok = d <= r[:, None]
    if p.shape[1]:
        ok &= ~(p[:, :, None] == c[:, None, :]).any(dim=1)
    return ok


@solver_entry(spec="_ir_cases_admission")
def admission(dvals, rem, cand, pref) -> torch.Tensor:
    """(M, C) bool mask: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    d, r, c, p = check_admission_dtype(dvals, rem, cand, pref)
    if d.device.type == "cpu":
        return admission_ref(d, r, c, p)
    return _admission_cuda(d, r, c, p)


def _admission_cuda(d, r, c, p):
    global launches
    if d.device.type != "cuda" or not (r.device == c.device == p.device
                                       == d.device):
        raise ValueError("admission operands must share one CUDA device")
    if not all(x.is_contiguous() for x in (d, r, c, p)):
        raise ValueError("admission operands must be contiguous")
    m, cc = d.shape
    w = p.shape[1]
    if m * cc >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError("admission shape exceeds the kernel's 32-bit index")
    out = torch.empty((m, cc), dtype=torch.int8, device=d.device)
    if m * cc:
        lib = _build.library("admission", _SIGS)
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream(d.device).cuda_stream
            err = lib.admission_launch(
                d.data_ptr(), r.data_ptr(), c.data_ptr(), p.data_ptr(),
                out.data_ptr(), m, cc, w, stream,
            )
        _build.check_launch(err, "admission kernel")
        with _build.COUNT_LOCK:
            launches += 1
    return out != 0


def admission_prune(  # repro-lint: disable=JF100 host loop around admission
    dist_rows: np.ndarray,
    dst_row: np.ndarray,
    cand: np.ndarray,
    rem: np.ndarray,
    pref: np.ndarray | None = None,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Admissibility (+ simplicity when ``pref`` is given) mask for one
    expansion level, computed on ``device``; returns a numpy bool array.

    ``dist_rows`` is the enumerator's (R, N+1) f32 distance tile (trailing
    +inf sentinel column) and ``dst_row`` the (M,) tile row of each frontier
    row's destination.  The candidate-distance gather runs on the host
    (the same gather the numpy backend does); the comparison and the
    prefix-membership test run in :func:`admission`.
    """
    dev = resolve(device)
    dvals = dist_rows[dst_row[:, None], cand]
    if pref is None:
        pref = np.zeros((cand.shape[0], 0), dtype=np.int32)
    mask = admission(
        torch.from_numpy(np.ascontiguousarray(dvals, dtype=np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(rem, dtype=np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(cand, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(pref, dtype=np.int32)).to(dev),
    )
    return mask.cpu().numpy()


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

def _ir_cases_admission():
    def make(dev):
        rng = np.random.default_rng(0)
        M, C, W = 32, 6, 3
        args = (rng.integers(0, 5, (M, C)).astype(np.float32),
                rng.integers(0, 5, M).astype(np.float32),
                rng.integers(0, 16, (M, C)).astype(np.int32),
                rng.integers(-1, 16, (M, W)).astype(np.int32))
        return tuple(torch.as_tensor(x, device=dev) for x in args), {}

    return [AuditCase(label="mask", make=make, budget=False,
                      kernels=("admission",))]
