"""Min-plus (tropical semiring) matrix product.

APSP on the switch graph is min-plus matrix powering: with D the weighted
adjacency (0 diagonal, 1 for edges, +inf otherwise), ``D^(2t) = D^t (min,+)
D^t`` converges to all-pairs distances in ceil(log2(diameter)) squarings.
:func:`minplus` launches the hand-written kernel of ``csrc/minplus.cu`` on a
CUDA tensor and uses the plain version :func:`minplus_ref` on a CPU tensor.
Both are exact on hop counts (sums and minimums of small integers in
float32), so they agree bit for bit.

Replaces ``repro/kernels/minplus.py`` (``minplus_pallas``) and
``repro/kernels/ref.py::minplus_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["check_minplus_dtype", "minplus", "minplus_ref", "launches"]

#: Launches of the CUDA kernel since import (or the last reset).
launches = 0

_SIGS = {
    "minplus_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}

#: Working-set budget of the plain version's (M, chunk, N) broadcast.
_REF_CHUNK_BYTES = 64 << 20


def check_minplus_dtype(*arrays) -> tuple:
    """Validate/upcast min-plus operands: floating only (+inf is the
    padding identity), half precision upcast to float32."""
    out = []
    for x in arrays:
        if not isinstance(x, torch.Tensor):
            raise TypeError("min-plus operands must be torch.Tensors")
        if not x.is_floating_point():
            raise ValueError(
                f"min-plus operands must be floating point (got {x.dtype}): "
                "+inf is the identity of min; convert int16 hop matrices "
                "with an explicit sentinel -> inf mapping first"
            )
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.to(torch.float32)
        out.append(x)
    a, b = out
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"min-plus needs (M, K) x (K, N); got {tuple(a.shape)} x "
            f"{tuple(b.shape)}"
        )
    return a, b


def minplus_ref(a, b) -> torch.Tensor:
    """Plain torch ``C[i, j] = min_k A[i, k] + B[k, j]``.

    The K axis is walked in strips so the (M, strip, N) broadcast stays
    within ``_REF_CHUNK_BYTES``; min is exact in any order.
    """
    a, b = check_minplus_dtype(a, b)
    m, k = a.shape
    n = b.shape[1]
    dtype = torch.promote_types(a.dtype, b.dtype)
    acc = torch.full((m, n), float("inf"), dtype=dtype, device=a.device)
    if k == 0:
        return acc
    strip = max(1, _REF_CHUNK_BYTES // max(4 * m * n, 1))
    for k0 in range(0, k, strip):
        cand = (a[:, k0:k0 + strip, None] + b[None, k0:k0 + strip, :]).amin(1)
        acc = torch.minimum(acc, cand)
    return acc


def minplus(a, b) -> torch.Tensor:
    """Tropical product: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    a, b = check_minplus_dtype(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_ref(a, b)
    return _minplus_cuda(a, b)


def _minplus_cuda(a, b):
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"min-plus operands must share one CUDA device; got {a.device}, "
            f"{b.device}"
        )
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("the min-plus kernel takes float32 operands")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("min-plus operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or m * k >= 2 ** 62:
        raise ValueError("min-plus shape exceeds the kernel's index range")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if k == 0:
        return out.fill_(float("inf"))
    lib = _build.library("minplus", _SIGS)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.minplus_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream
        )
    _build.check_launch(err, "min-plus kernel")
    launches += 1
    return out
