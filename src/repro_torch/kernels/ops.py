"""Public wrappers around the port's kernels, and the size/device policy.

Every wrapper dispatches on the device of the tensors it is given: the
hand-written CUDA kernel on a CUDA tensor, the plain torch version on a CPU
tensor (see ``congestion.py``, ``minplus.py``, ``admission.py``).  There is
no backend switch that sends a CUDA tensor to a plain version.

Flow-solver backend selection
-----------------------------
The MW inner loop (``core.flow``) needs the fused incidence products
``(B^T r, B w)`` every iteration.  Whether to materialize the dense (P, S)
incidence B and call the fused congestion kernel, or to stay with the
ordered gathers over the padded path table, is answered here by
``preferred_congestion_backend``:

* On CUDA: ``dense`` while the whole (stacked) incidence fits
  ``DENSE_INCIDENCE_BUDGET_BYTES`` of the card's memory, the ordered
  ``gather`` beyond it.  (The TPU policy's 4 GiB budget would have pushed
  the paper-scale probe off the kernel; an 80 GB H100 holds it.)
* On the CPU: ``gather`` for batches, and for single instances ``dense``
  only for toy sizes, exactly as the reference chooses on its CPU.
* A loads-only product (``loads_only=True``: the caller consumes no path
  costs, as the simulator's waterfill) is ``gather`` on every device: its
  fan-in read (at most 8 P L bytes a member; on CUDA the kernel of
  ``fanin.py``) beats the dense read (4 P S bytes) whenever S > 2 L, which
  a network's slot count always is.

``apsp_minplus`` is APSP by dense min-plus squaring of an f32 matrix on the
device; ``apsp_minplus_blocked`` keeps the canonical int16 hop matrix on the
device and squares it one row band at a time, with the int16 (DPX) form of
the product up to ``minplus.HOPS_MAX_N`` nodes and the float32 form above
(``apsp_form``).  ``power_iteration_lambda2``
is lambda_2 of the Laplacian by block power iteration, its ``A @ Q`` step
through the matmul kernel.  Replaces ``repro/kernels/ops.py`` (ops.py:78-340).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..analysis.registry import AuditCase, solver_entry
from ..device import is_cuda, resolve
from .congestion import congestion as _congestion
from .minplus import HOPS_MAX_N
from .minplus import minplus as _minplus
from .minplus import minplus_hops as _minplus_hops
from .power import matmul as _matmul

__all__ = [
    "DENSE_INCIDENCE_BUDGET_BYTES",
    "apsp_form",
    "apsp_minplus",
    "apsp_minplus_blocked",
    "congestion",
    "congestion_loads",
    "matmul",
    "minplus",
    "power_iteration_lambda2",
    "preferred_congestion_backend",
]

# int16 "unreachable" sentinel of the canonical hop representation (equal to
# repro_torch.core.metrics.INT16_INF; kernels do not import core).
_INT16_INF = np.int16(np.iinfo(np.int16).max)

#: Dense incidence budget for the fused congestion kernel on an H100: the
#: stacked f32 B lives in device memory next to the solver state.  24 GiB
#: of the card's 80 GB holds the Fig 1c probe's ~9.4 GB stack with room for
#: the partial-load scratch and everything else on the card.
DENSE_INCIDENCE_BUDGET_BYTES = 24 << 30
#: On the CPU a dense B only beats the gathers for toy instances.
_CPU_DENSE_LIMIT_BYTES = 8 << 20


def preferred_congestion_backend(
    n_paths: int,
    n_slots: int,
    dense_budget_bytes: int | None = None,
    n_batch: int = 1,
    device: "str | torch.device" = "cuda",
    loads_only: bool = False,
) -> str:
    """Pick the flow-solver congestion backend ('dense' or 'gather').

    ``n_paths`` x ``n_slots`` is the incidence shape (P, S); ``n_batch`` > 1
    is the batched solver asking about a stacked (n_batch, P, S) incidence,
    whose whole stack must fit the budget.  ``loads_only`` is a caller that
    needs ``B^T r`` alone: ``gather`` whatever the size and device.
    """
    if loads_only:
        return "gather"
    bytes_needed = 4 * int(n_paths) * int(n_slots) * max(int(n_batch), 1)
    if is_cuda(device):
        budget = (
            DENSE_INCIDENCE_BUDGET_BYTES
            if dense_budget_bytes is None
            else dense_budget_bytes
        )
        return "dense" if bytes_needed <= budget else "gather"
    if int(n_batch) > 1:
        return "gather"
    limit = (
        _CPU_DENSE_LIMIT_BYTES if dense_budget_bytes is None else dense_budget_bytes
    )
    return "dense" if bytes_needed <= limit else "gather"


@solver_entry(spec="_ir_cases_minplus", kind="wrapper")
def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[i, j] = min_k A[i, k] + B[k, j]`` (kernel on CUDA tensors)."""
    return _minplus(a, b)


@solver_entry(spec="_ir_cases_matmul", kind="wrapper")
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` (kernel on CUDA tensors)."""
    return _matmul(a, b)


@solver_entry(spec="_ir_cases_congestion", kind="wrapper")
def congestion(incidence, rates, prices, extents=None):
    """Fused ``(B^T r, B w)``; a rank-3 ``incidence`` runs one product per
    stacked batch member, over each member's ``extents=(rows, cols)`` when
    given (kernel on CUDA tensors; see ``kernels.congestion.congestion``)."""
    return _congestion(incidence, rates, prices, extents)


@solver_entry(spec="_ir_cases_congestion_loads", kind="wrapper")
def congestion_loads(incidence, rates, extents=None) -> torch.Tensor:
    """Loads-only ``B^T r`` over a dense (or stacked rank-3) incidence: the
    fused call with zero prices, over each member's ``extents=(rows,
    cols)`` when given (as ``congestion``: the kernel reads none of the
    padding, and a filler member's loads are exact zeros).  The kernel
    reads each B entry once either way, so the discarded costs half moves
    no extra bytes."""
    b = incidence
    zeros = torch.zeros(b.shape[:-2] + (b.shape[-1],), dtype=torch.float32,
                        device=b.device)
    return _congestion(b, rates, zeros, extents)[0]


def _squarings_to_cover(cover: int) -> int:
    """Number of min-plus squarings after which ``D^(2^t)`` spans ``cover`` hops."""
    steps = 0
    m = 1
    while m < max(cover, 1):
        m *= 2
        steps += 1
    return steps


def apsp_minplus(  # repro-lint: disable=JF100 host fixed-point loop of minplus
    adj,
    diameter_hint: int | None = None,
    certify: bool = True,
    device: "str | torch.device" = "cuda",
) -> torch.Tensor:
    """All-pairs hop distances by min-plus squaring of the adjacency (f32,
    +inf for unreachable pairs, on ``device``).

    With ``diameter_hint``, ``ceil(log2(hint))`` squarings run without a
    host sync, then one fixed-point check certifies the result (only an
    undershooting hint pays further squarings); ``certify=False`` trusts
    the hint.  Without a hint, squaring stops at the first fixed point.
    """
    dev = resolve(device)
    a = torch.as_tensor(np.asarray(adj), device=dev)
    n = a.shape[0]
    d = torch.where(a > 0, 1.0, float("inf")).to(torch.float32)
    d.fill_diagonal_(0.0)
    done = 0
    if diameter_hint is not None:
        steps = _squarings_to_cover(diameter_hint)
        for _ in range(steps):
            d = _minplus(d, d)
        done = steps
        if not certify:
            return d
    m = 1 << done
    while True:
        new = _minplus(d, d)
        m *= 2
        if torch.equal(new, d):  # fixed point: all distances found
            return new
        d = new
        if m >= max(n - 1, 1):
            return d


def _tiles_f32(d16: torch.Tensor) -> torch.Tensor:
    """float32 copy of an int16 hop matrix: sentinel -> +inf."""
    t = d16.to(torch.float32)
    return t.masked_fill_(d16 == int(_INT16_INF), float("inf"))


def apsp_form(n: int) -> str:
    """The min-plus form ``apsp_minplus_blocked`` squares an n-node hop
    matrix with: ``"hops"`` (int16, DPX) while n <= ``HOPS_MAX_N`` (16383),
    where every true distance stays below the int16 form's working infinity,
    ``"f32"`` above it.  A rule on the shape, decided before any launch."""
    return "hops" if n <= HOPS_MAX_N else "f32"


def apsp_minplus_blocked(  # repro-lint: disable=JF100 host loop of the products
    adj,
    bm: int = 2048,
    diameter_hint: int | None = None,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """APSP by min-plus powering of a device-resident int16 hop matrix;
    returns the canonical int16 matrix (``INT16_INF`` sentinel) on the host.

    The distance state stays on ``device`` in the canonical int16 form (two
    matrices, current and next power: ``4 N^2`` bytes; 134 MB each at
    N = 8192), and each squaring runs the min-plus product one ``bm``-row
    band at a time, in the form ``apsp_form(N)`` picks: ``"hops"`` squares
    the int16 state as it is, each band written straight into the next
    power; ``"f32"`` (N > 16383) converts the current power to float32 once
    a squaring and writes each band back as int16.  The
    fixed-point check (``torch.equal``) runs after every squaring, so the
    driver always stops at a *certified* fixed point bounded by the
    ``n - 1`` worst case; ``diameter_hint`` is accepted for API symmetry
    with ``apsp_minplus`` and does not bound it.
    """
    a = np.asarray(adj)
    n = a.shape[0]
    if n >= int(_INT16_INF):
        raise ValueError(
            f"N = {n} >= int16 sentinel {int(_INT16_INF)}: distances could "
            "overflow the canonical int16 hop representation"
        )
    form = apsp_form(n)
    if n <= 1:
        return np.zeros((n, n), dtype=np.int16)
    del diameter_hint  # see docstring: the fixed-point check certifies
    dev = resolve(device)
    # the one-hop matrix, built on the device from the adjacency
    cur = torch.full((n, n), int(_INT16_INF), dtype=torch.int16, device=dev)
    cur.masked_fill_(torch.as_tensor(a, device=dev) != 0, 1)
    cur.fill_diagonal_(0)
    inf16 = float(_INT16_INF)
    for _ in range(max(_squarings_to_cover(n - 1), 1)):
        nxt = torch.empty_like(cur)
        if form == "hops":
            for i0 in range(0, n, bm):
                _minplus_hops(cur[i0:i0 + bm], cur, out=nxt[i0:i0 + bm])
        else:
            df = _tiles_f32(cur)
            for i0 in range(0, n, bm):
                band = _minplus(df[i0:i0 + bm], df)
                # finite entries are true hop counts (< n < sentinel)
                nxt[i0:i0 + bm] = torch.where(
                    torch.isfinite(band), band, inf16
                ).to(torch.int16)
        if torch.equal(nxt, cur):
            return nxt.cpu().numpy()
        cur = nxt
    return cur.cpu().numpy()


@obs.spanned("spectral/lambda2")
def power_iteration_lambda2(  # repro-lint: disable=JF100 host loop of matmul
    adj,
    iters: int = 300,
    block: int = 8,
    seed: int = 0,
    v0=None,
    device: "str | torch.device" = "cuda",
) -> float:
    """lambda_2 of the Laplacian via block power iteration on B = cI - L.

    The reference's loop step for step: deflate the block against the
    all-ones top eigenvector, re-orthonormalize with ``torch.linalg.qr``,
    apply ``B q = c q - D q + A q`` with ``A @ q`` through the matmul kernel
    (one launch per iteration plus one for the final Rayleigh quotients),
    and return ``c`` minus the largest Rayleigh quotient, clipped at 0.  As
    a Rayleigh estimate it can only sit at or above the true lambda_2.

    The start block is ``torch.randn`` from a ``torch.Generator`` seeded by
    ``seed``.  Torch cannot reproduce the reference's
    ``jax.random.normal(PRNGKey(seed))`` stream, so ``v0`` (an
    ``(n, block)`` array) lets a caller hand both packages the same start
    block; it overrides ``seed``.
    """
    dev = resolve(device)
    a = torch.as_tensor(adj, dtype=torch.float32).to(dev)
    n = a.shape[0]
    obs.annotate(n=n, iters=iters, block=block)
    deg = a.sum(dim=1)
    c = 2.0 * deg.max() + 1.0
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev) / float(np.sqrt(n))
    if v0 is None:
        gen = torch.Generator().manual_seed(int(seed))
        v = torch.randn((n, block), generator=gen, dtype=torch.float32)
    else:
        v = torch.tensor(np.asarray(v0, dtype=np.float32))
        if tuple(v.shape) != (n, block):
            raise ValueError(
                f"v0 must have shape {(n, block)}; got {tuple(v.shape)}"
            )
    v = v.to(dev)

    def apply_b(v):
        v = v - ones @ (ones.T @ v)
        q, _ = torch.linalg.qr(v)
        # B @ q = c q - D q + A q ; the A @ q product is the kernel call
        return q, c * q - deg[:, None] * q + _matmul(a, q)

    for _ in range(iters):
        _, v = apply_b(v)
    q, w = apply_b(v)
    lam_b = torch.diagonal(q.T @ w)
    lam2 = c - lam_b.max()
    return float(torch.clamp(lam2, min=0.0))


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

_IR_WRAPPER_EXEMPT = {
    "JF101": "the dense congestion and matmul wrappers contract by design "
    "(the kernels on CUDA, the plain products on the CPU); bit-exact "
    "solver paths never route through them",
}


def _ir_cases_congestion():
    from .congestion import _ir_operands

    return [AuditCase(label="rank2", exempt=_IR_WRAPPER_EXEMPT, budget=False,
                      kernels=("congestion",),
                      make=lambda dev: (_ir_operands(dev, (24, 40)), {}))]


def _ir_cases_congestion_loads():
    from .congestion import _ir_operands

    def make(dev):
        inc, rates, _ = _ir_operands(dev, (2, 24, 40))
        return (inc, rates), {}

    return [AuditCase(label="rank3", make=make, exempt=_IR_WRAPPER_EXEMPT,
                      budget=False, kernels=("congestion_batch",))]


def _ir_cases_minplus():
    from .minplus import _ir_cases_minplus as cases

    return cases()


def _ir_cases_matmul():
    from .power import _ir_cases_matmul as cases

    return cases()
