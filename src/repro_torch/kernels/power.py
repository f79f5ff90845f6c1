"""Dense matrix product for spectral power iteration.

The bisection machinery (paper §4.1 Fig 1, §4.2 Fig 6) lower-bounds cut
widths with lambda_2 of the graph Laplacian, computed by deflated block
power iteration (``ops.power_iteration_lambda2``).  Its hot step is
``A @ Q``: the N x N adjacency times a skinny block of iteration vectors.
:func:`matmul` launches the hand-written kernel of ``csrc/matmul.cu`` on
CUDA tensors and uses the plain version :func:`matmul_ref` on CPU tensors.
float32 accumulates in float32 and float64 in float64; the two versions sum
in different orders, so they agree to rounding, not bit for bit.

Replaces ``repro/kernels/power.py`` (``check_matmul_dtype``,
``matmul_kernel``, ``matmul_pallas``) and ``repro/kernels/ref.py::matmul_ref``.

A product at most ``NARROW_MAX_N`` = 16 columns wide (every product of the
spectral path) runs the narrow row-band kernel; a wider one the 64 x 64 tile
kernel.  :func:`narrow_plan` chooses the narrow kernel's band height and
whether it copies A's rows and B's columns 16 bytes at a time (contiguous,
aligned operands) or one element at a time (any other strides).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..analysis.registry import AuditCase, solver_entry

__all__ = ["NARROW_MAX_N", "check_matmul_dtype", "matmul", "matmul_ref",
           "narrow_plan", "launches"]

#: Widest product (columns of B) the narrow kernel takes.
NARROW_MAX_N = 16

#: Launches of the CUDA kernel since import (or the last reset).
launches = 0

_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]
_SIG_NARROW = _SIG[:-1] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SIGS = {"matmul_f32_launch": _SIG, "matmul_f64_launch": _SIG,
         "matmul_narrow_f32_launch": _SIG_NARROW,
         "matmul_narrow_f64_launch": _SIG_NARROW}


def check_matmul_dtype(a, b) -> tuple:
    """Validate/upcast matmul operands before any padding or launch (JF004).

    Integer and bool operands raise ``ValueError``; half precision is
    upcast to float32; both operands are then brought to their common type
    (float32 or float64), which is also the type of the result.
    """
    out = []
    for x in (a, b):
        if not isinstance(x, torch.Tensor):
            raise TypeError("matmul operands must be torch.Tensors")
        if not x.is_floating_point():
            raise ValueError(
                f"matmul operands must be floating point (got {x.dtype}): "
                "cast explicitly before calling matmul"
            )
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.to(torch.float32)
        out.append(x)
    a, b = out
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul needs (M, K) x (K, N); got {tuple(a.shape)} x "
            f"{tuple(b.shape)}"
        )
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def narrow_plan(a, b, n_sm: int) -> dict:
    """The narrow kernel's launch for ``A @ B`` on a card of ``n_sm`` SMs.

    ``band_rows``: 16 rows a block while that still gives at least two
    blocks per SM, else 8 (8192 rows: 512 blocks; 792 rows: 99).
    ``vec_a`` / ``vec_b``: 16-byte copies of A's rows / B's columns, where
    they are contiguous, K is a multiple of the 16 bytes' elements and the
    pointer and leading stride are 16-byte aligned; else the kernel copies
    one element at a time from any strides.
    """
    m, k = a.shape
    n = b.shape[1]
    vec = 16 // a.element_size()
    band_rows = 16 if -(-m // 16) >= 2 * n_sm else 8
    vec_a = (a.stride(1) == 1 and k % vec == 0
             and (m == 1 or a.stride(0) % vec == 0)
             and a.data_ptr() % 16 == 0)
    vec_b = (b.stride(0) == 1 and k % vec == 0
             and (n == 1 or b.stride(1) % vec == 0)
             and b.data_ptr() % 16 == 0)
    return {"band_rows": band_rows, "vec_a": vec_a, "vec_b": vec_b}


@solver_entry(spec="_ir_cases_matmul_ref")
def matmul_ref(a, b) -> torch.Tensor:
    """Plain torch ``A @ B`` in the operands' common type."""
    a, b = check_matmul_dtype(a, b)
    return torch.matmul(a, b)


@solver_entry(spec="_ir_cases_matmul")
def matmul(a, b) -> torch.Tensor:
    """``A @ B``: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors.  Operands may have any strides (a transposed view, or the
    column-major Q of ``torch.linalg.qr``)."""
    a, b = check_matmul_dtype(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    return _matmul_cuda(a, b)


def _matmul_cuda(a, b):
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"matmul operands must share one CUDA device; got {a.device}, "
            f"{b.device}"
        )
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("matmul shape exceeds the kernel's index range")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    f64 = a.dtype == torch.float64
    lib = _build.library("matmul", _SIGS)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            a.stride(0), a.stride(1), b.stride(0), b.stride(1))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if n <= NARROW_MAX_N:
            plan = narrow_plan(a, b, torch.cuda.get_device_properties(
                a.device).multi_processor_count)
            fn = lib.matmul_narrow_f64_launch if f64 \
                else lib.matmul_narrow_f32_launch
            err = fn(*args, plan["band_rows"], int(plan["vec_a"]),
                     int(plan["vec_b"]), stream)
        else:
            fn = lib.matmul_f64_launch if f64 else lib.matmul_f32_launch
            err = fn(*args, stream)
    _build.check_launch(err, "matmul kernel")
    with _build.COUNT_LOCK:
        launches += 1
    return out


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

_IR_MATMUL_EXEMPT = {
    "JF101": "a matmul contracts by definition; no bit-exactness contract "
    "applies to the spectral-gap path",
}


def _ir_operands(dev, m: int = 40, k: int = 40, n: int = 8) -> tuple:
    """Seeded float32 ``A`` (m, k) and ``Q`` (k, n): the power iteration's
    narrow product."""
    g = torch.Generator().manual_seed(0)
    return (torch.rand((m, k), generator=g).to(dev),
            torch.randn((k, n), generator=g).to(dev))


def _ir_cases_matmul():
    return [AuditCase(label="narrow", exempt=_IR_MATMUL_EXEMPT, budget=False,
                      kernels=("matmul",),
                      make=lambda dev: (_ir_operands(dev), {}))]


def _ir_cases_matmul_ref():
    return [AuditCase(label="narrow", exempt=_IR_MATMUL_EXEMPT,
                      make=lambda dev: (_ir_operands(dev), {}))]
