"""Min-plus (tropical semiring) matrix product.

APSP on the switch graph is min-plus matrix powering: with D the weighted
adjacency (0 diagonal, 1 for edges, +inf otherwise), ``D^(2t) = D^t (min,+)
D^t`` converges to all-pairs distances in ceil(log2(diameter)) squarings.
Two forms of the product, each a hand-written kernel of ``csrc/minplus.cu``
on CUDA tensors and a plain torch version on CPU tensors:

* :func:`minplus` on float32 (+inf the identity of min), plain version
  :func:`minplus_ref`.  Exact on hop counts (sums and minimums of small
  integers in float32), so kernel and plain version agree bit for bit.
* :func:`minplus_hops` on canonical int16 hop matrices (``INT16_INF`` =
  32767 for unreachable pairs), plain version :func:`minplus_hops_ref`.
  The kernel uses Hopper's DPX add-min on two 16-bit values at once.  Its
  contract: finite entries lie in ``[0, HOPS_INF)``, ``HOPS_INF`` = 16383
  being the working infinity that sentinels load as (so no 16-bit sum
  wraps), and any result at or above ``HOPS_INF`` is reported as the
  sentinel.  Entries outside that range are clamped into ``[0, HOPS_INF]``
  on load (a negative entry reads as 0), by the kernel and the plain
  version alike.  For a squaring of the hop matrix of a graph of at most
  ``HOPS_MAX_N`` = 16383 nodes that is the exact product.

:func:`launch_plan` chooses each kernel's output tile and how far K is
split across blocks to fill the card (split-K is exact: min does not depend
on order).  Replaces ``repro/kernels/minplus.py`` (``minplus_pallas``) and
``repro/kernels/ref.py::minplus_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..analysis.registry import AuditCase, solver_entry

__all__ = ["HOPS_INF", "HOPS_MAX_N", "INT16_INF", "check_minplus_dtype",
           "copy_width", "launch_plan", "minplus", "minplus_hops",
           "minplus_hops_ref", "minplus_ref", "pair_rate", "launches",
           "hops_launches"]

#: Launches of the float32 kernel since import (or the last reset).
launches = 0
#: Launches of the int16 (DPX) kernel since import (or the last reset).
hops_launches = 0

#: Unreachable sentinel of the canonical int16 hop matrix (equal to
#: ``repro_torch.core.metrics.INT16_INF``; kernels do not import core).
INT16_INF = 32767
#: Working infinity of the int16 form: sentinels load as this, so the sum of
#: two loaded values is at most 32766 and never wraps in 16 bits.
HOPS_INF = 16383
#: Largest graph whose hop matrix the int16 form squares exactly: every true
#: distance is at most n - 1 < HOPS_INF.
HOPS_MAX_N = HOPS_INF

#: Output tile (rows, columns) of a block, and the K depth of one stage.
F32_TILE = (128, 128)
HOPS_TILE = (128, 256)
K_STEP = 16
#: Blocks of either kernel that one SM holds at once (registers bound it).
BLOCKS_PER_SM = 2
#: Most bytes of split-K partials a launch writes: a third of the card's
#: 50 MB L2, where the reduction then finds them.
SCRATCH_BUDGET_BYTES = 16 << 20

_LAUNCH_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SIGS = {
    "minplus_f32_launch": _LAUNCH_SIG,
    "minplus_hops_launch": _LAUNCH_SIG,
    "minplus_rate_launch": [ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_uint] * 2 + [ctypes.c_void_p],
}

#: Working-set budget of the plain versions' (M, chunk, N) broadcast.
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
                "+inf is the identity of min; square canonical int16 hop "
                "matrices with minplus_hops"
            )
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.to(torch.float32)
        out.append(x)
    a, b = out
    _check_shapes(a, b)
    return a, b


def _check_shapes(a, b) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"min-plus needs (M, K) x (K, N); got {tuple(a.shape)} x "
            f"{tuple(b.shape)}"
        )


def launch_plan(m: int, n: int, k: int, n_sm: int, hops: bool = False) -> dict:
    """A kernel's launch for an (m, k) x (k, n) product on ``n_sm`` SMs.

    ``tile``: the block's output tile (128 x 128 float32, 128 x 256 int16).
    K is split across blocks only when the tiles give fewer than
    ``BLOCKS_PER_SM`` blocks per SM.  Then each of ``splits`` ranges takes
    ``k_per_split`` positions (whole ``K_STEP`` chunks, the last range
    possibly shorter, none empty), chosen to give the busiest SM the fewest
    chunks: ``ceil(blocks / n_sm)`` blocks of ``k_per_split / K_STEP``
    chunks each, so a block count just past a multiple of the SMs (a
    nearly empty last wave) loses to a smaller one; ties go to fewer
    splits.  The partials (``splits`` x m x n) stay within
    ``SCRATCH_BUDGET_BYTES`` so that they stay in L2 for the reduction.
    """
    tm, tn = HOPS_TILE if hops else F32_TILE
    tiles = -(-m // tm) * -(-n // tn)
    chunks = max(-(-k // K_STEP), 1)
    per = chunks
    if tiles < BLOCKS_PER_SM * n_sm:
        max_splits = max(SCRATCH_BUDGET_BYTES // (m * n * (2 if hops else 4)),
                         1)
        best = None
        for p in range(chunks, 0, -1):
            splits = -(-chunks // p)
            if splits > max_splits:
                break
            cost = -(-tiles * splits // n_sm) * p
            if best is None or cost < best:
                best, per = cost, p
    splits = -(-chunks // per)
    return {"tile": (tm, tn), "splits": splits, "k_per_split": per * K_STEP,
            "blocks": tiles * splits}


def copy_width(*tensors) -> int:
    """Bytes per cp.async copy the kernel may use on these row-major
    operands and output: 16 when every row length is a multiple of 16 bytes
    and every pointer 16-byte aligned, else 4 when both hold for 4 bytes,
    else the element size (int16 rows of odd length: plain loads)."""
    for width in (16, 4):
        if all(t.shape[-1] * t.element_size() % width == 0
               and t.data_ptr() % width == 0 for t in tensors):
            return width
    return tensors[0].element_size()


@solver_entry(spec="_ir_cases_minplus_ref")
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


def _check_hops(a, b) -> None:
    for x in (a, b):
        if not isinstance(x, torch.Tensor):
            raise TypeError("min-plus operands must be torch.Tensors")
        if x.dtype != torch.int16:
            raise ValueError(
                f"minplus_hops takes canonical int16 hop matrices (got "
                f"{x.dtype}); use minplus for floating-point operands"
            )
    _check_shapes(a, b)


def minplus_hops_ref(a, b) -> torch.Tensor:
    """Plain torch min-plus product of int16 hop matrices, the int16 form's
    contract exactly: entries are clamped into ``[0, HOPS_INF]`` (the
    sentinel becomes ``HOPS_INF``, a negative entry 0), the minimum over K
    of the int32 sums is capped at ``HOPS_INF``, and ``HOPS_INF`` is
    returned as ``INT16_INF``."""
    _check_hops(a, b)
    m, k = a.shape
    n = b.shape[1]
    acc = torch.full((m, n), HOPS_INF, dtype=torch.int32, device=a.device)
    a32 = a.to(torch.int32).clamp_(0, HOPS_INF)
    b32 = b.to(torch.int32).clamp_(0, HOPS_INF)
    strip = max(1, _REF_CHUNK_BYTES // max(4 * m * n, 1))
    for k0 in range(0, k, strip):
        cand = (a32[:, k0:k0 + strip, None]
                + b32[None, k0:k0 + strip, :]).amin(1)
        acc = torch.minimum(acc, cand)
    return acc.masked_fill_(acc >= HOPS_INF, INT16_INF).to(torch.int16)


@solver_entry(spec="_ir_cases_minplus")
def minplus(a, b) -> torch.Tensor:
    """Tropical product: the float32 kernel on CUDA tensors, the plain
    version on CPU tensors."""
    a, b = check_minplus_dtype(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_ref(a, b)
    return _launch(a, b, None, hops=False)


@solver_entry(spec="_ir_cases_minplus_hops")
def minplus_hops(a, b, out=None) -> torch.Tensor:
    """Tropical product of canonical int16 hop matrices: the DPX kernel on
    CUDA tensors, the plain version on CPU tensors.  ``out`` (a contiguous
    (M, N) int16 tensor, such as a row band of the APSP driver's next
    power) receives the result."""
    _check_hops(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        result = minplus_hops_ref(a, b)
        return result if out is None else out.copy_(result)
    return _launch(a, b, out, hops=True)


def _launch(a, b, out, hops: bool):
    global launches, hops_launches
    dtype = torch.int16 if hops else torch.float32
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"min-plus operands must share one CUDA device; got {a.device}, "
            f"{b.device}"
        )
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"this min-plus kernel takes {dtype} operands")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("min-plus operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or max(m * k, k * n, m * n) >= 2 ** 62:
        raise ValueError("min-plus shape exceeds the kernel's index range")
    if out is None:
        out = torch.empty((m, n), dtype=dtype, device=a.device)
    elif (out.dtype != dtype or tuple(out.shape) != (m, n)
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous ({m}, {n}) {dtype} tensor on "
            f"{a.device}"
        )
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.fill_(INT16_INF if hops else float("inf"))
    plan = launch_plan(m, n, k, torch.cuda.get_device_properties(
        a.device).multi_processor_count, hops=hops)
    scratch = None
    if plan["splits"] > 1:
        scratch = torch.empty((plan["splits"], m, n), dtype=dtype,
                              device=a.device)
    lib = _build.library("minplus", _SIGS)
    fn = lib.minplus_hops_launch if hops else lib.minplus_f32_launch
    # the float32 kernel copies A one element at a time (transposing it);
    # its width applies to B and the output
    width = copy_width(a, b, out) if hops else copy_width(b, out)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), m, n, k,
                 plan["k_per_split"], plan["splits"], width, stream)
    _build.check_launch(err, "min-plus kernel")
    with _build.COUNT_LOCK:
        if hops:
            hops_launches += 1
        else:
            launches += 1
    return out


def pair_rate(form: str, device: "str | torch.device" = "cuda",
              blocks_per_sm: int = 8, iters: int = 4096) -> float:
    """The card's add-min issue rate, in (i, j, k) pairs a second, measured
    with ``minplus_rate_kernel``: ``form`` "dpx" times ``__viaddmin_s16x2``
    (two pairs an instruction), "f32" the FADD + FMNMX pair.  No data sheet
    gives the DPX rate; it bounds the int16 form.  Not a min-plus launch."""
    kind = {"dpx": 0, "f32": 1}[form]
    dev = torch.device(device)
    blocks = blocks_per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count
    sink = torch.zeros(blocks, dtype=torch.int32, device=dev)
    lib = _build.library("minplus", _SIGS)
    # b adds 1 to both halves (or 1.0f), c caps at 0x7000 (or 1e30f)
    b, c = (0x00010001, 0x70007000) if kind == 0 else (0x3F800000, 0x7149F2CA)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            _build.check_launch(lib.minplus_rate_launch(
                sink.data_ptr(), kind, blocks, iters, b, c, stream),
                "min-plus rate kernel")

        run()  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(stop) / 1e3
    instructions = blocks * 256 * iters * 16 * 8
    return instructions * (2 if kind == 0 else 1) / seconds


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

def _ir_hops(dev, n: int = 24, seed: int = 0) -> torch.Tensor:
    """A seeded int16 hop matrix of ``n`` nodes: small distances, some
    unreachable (``INT16_INF``), zero diagonal."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(1, 6, (n, n), generator=g, dtype=torch.int16)
    d[torch.rand((n, n), generator=g) < 0.2] = INT16_INF
    d.fill_diagonal_(0)
    return d.to(dev)


def _ir_f32(dev, n: int = 24) -> torch.Tensor:
    """The same matrix in float32, ``+inf`` where unreachable."""
    h = _ir_hops(dev, n)
    return torch.where(h == INT16_INF, float("inf"), h.to(torch.float32))


def _ir_cases_minplus():
    return [AuditCase(label="f32", budget=False, kernels=("minplus",),
                      make=lambda dev: ((_ir_f32(dev), _ir_f32(dev)), {}))]


def _ir_cases_minplus_hops():
    return [AuditCase(label="int16", budget=False, kernels=("minplus_hops",),
                      make=lambda dev: ((_ir_hops(dev), _ir_hops(dev)), {}))]


def _ir_cases_minplus_ref():
    return [AuditCase(label="f32",
                      make=lambda dev: ((_ir_f32(dev), _ir_f32(dev)), {}))]
