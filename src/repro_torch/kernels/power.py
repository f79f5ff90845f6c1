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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["check_matmul_dtype", "matmul", "matmul_ref", "launches"]

#: Launches of the CUDA kernel since import (or the last reset).
launches = 0

_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]
_SIGS = {"matmul_f32_launch": _SIG, "matmul_f64_launch": _SIG}


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


def matmul_ref(a, b) -> torch.Tensor:
    """Plain torch ``A @ B`` in the operands' common type."""
    a, b = check_matmul_dtype(a, b)
    return torch.matmul(a, b)


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
    fn = "matmul_f32_launch" if a.dtype == torch.float32 else "matmul_f64_launch"
    lib = _build.library("matmul", _SIGS)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fn)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            a.stride(0), a.stride(1), b.stride(0), b.stride(1), stream,
        )
    _build.check_launch(err, "matmul kernel")
    launches += 1
    return out
