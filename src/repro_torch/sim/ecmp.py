"""ECMP path sets and the deterministic flow hash (paper §3, Table 1).

The port of ``repro/sim/ecmp.py``.  The paper's Table 1 counts *distinct
paths* available to ECMP on a 686-server Jellyfish versus 8-shortest-path
routing, and Fig 9 shows the throughput consequence.  Two pieces reproduce
that here:

* ``ecmp_path_system`` (re-exported from ``core.routing``) — the set of
  equal-cost shortest paths per commodity, capped at the hardware way count
  (the batched enumerator with ``max_slack=0``).

* ``flow_hash`` — the per-flow path-selection hash: (src switch, dst
  switch, flow id, salt) through a murmur3-style 32-bit integer finalizer.
  Pure integer mixing — no Python ``hash()`` — so a flow's path is a pure
  function of its identifiers, the same under numpy and torch, on every
  device and in every process.  Torch's uint32 arithmetic is partial, so
  the torch form computes in int64 with every product split so that no
  intermediate leaves 64 bits, then masks to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.routing import ecmp_path_system

__all__ = [
    "ecmp_path_system",
    "flow_hash",
    "ecmp_group_sizes",
    "fattree_ecmp_check",
    "hash_select_rows",
]


# murmur3 fmix32 multipliers and the 32-bit golden-ratio increment: the
# standard avalanche constants — every output bit depends on every input bit.
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_PHI = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _mul32_np(h, m: int):
    return h * np.uint32(m)


def _mul32_torch(h: torch.Tensor, m: int) -> torch.Tensor:
    """``(h * m) mod 2^32`` for int64 ``h`` in [0, 2^32): the product by
    the low and the high 16 bits of ``m`` separately, each below 2^48."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h, mul):
    """murmur3's 32-bit finalizer (xor-shift / multiply avalanche)."""
    h = h ^ (h >> 16)
    h = mul(h, _M1)
    h = h ^ (h >> 13)
    h = mul(h, _M2)
    h = h ^ (h >> 16)
    return h


def flow_hash(src, dst, flow_id, salt=0):
    """Deterministic 32-bit mixing hash of a flow's identifiers.

    ``h = fmix(fmix(fmix(id ^ salt*phi) ^ src*M1) ^ dst*M2)`` over wrapping
    32-bit arithmetic; operands broadcast.  With any torch tensor operand
    the result is an int64 tensor holding the uint32 value (on that
    tensor's device); otherwise a numpy uint32 array.  The ECMP policy in
    ``sim.engine`` selects path ``h % n_equal_cost_paths``.
    """
    if any(isinstance(x, torch.Tensor) for x in (src, dst, flow_id, salt)):
        dev = next(x.device for x in (src, dst, flow_id, salt)
                   if isinstance(x, torch.Tensor))

        def u32(x):
            return torch.as_tensor(x, device=dev).to(torch.int64) & _MASK32

        s, d, f, q = u32(src), u32(dst), u32(flow_id), u32(salt)
        h = _fmix32(f ^ _mul32_torch(q, _PHI), _mul32_torch)
        h = _fmix32(h ^ _mul32_torch(s, _M1), _mul32_torch)
        return _fmix32(h ^ _mul32_torch(d, _M2), _mul32_torch)
    with np.errstate(over="ignore"):
        s = np.asarray(src).astype(np.uint32)
        d = np.asarray(dst).astype(np.uint32)
        f = np.asarray(flow_id).astype(np.uint32)
        q = np.asarray(salt).astype(np.uint32)
        h = _fmix32(f ^ (q * np.uint32(_PHI)), _mul32_np)
        h = _fmix32(h ^ (s * np.uint32(_M1)), _mul32_np)
        h = _fmix32(h ^ (d * np.uint32(_M2)), _mul32_np)
    return h


def hash_select_rows(ps, salt: int = 0) -> np.ndarray:
    """One hash-selected path row per server flow (Table 1's ECMP side).

    Expands each commodity into its ``demand``'s worth of unit server flows
    (flow ids are globally sequential) and picks each flow's path as
    ``flow_hash(src, dst, id, salt) % group_size`` — what a static ECMP
    fabric would do.  Requires pedigree (``ps.src``/``ps.dst``) and relies
    on ``build_path_system`` grouping path rows contiguously by commodity.
    """
    if ps.src is None or ps.dst is None or ps.unrouted is None:
        raise ValueError("hash_select_rows needs a path system with pedigree")
    kept = ~np.asarray(ps.unrouted)
    src = np.asarray(ps.src)[kept].astype(np.uint32)
    dst = np.asarray(ps.dst)[kept].astype(np.uint32)
    owner = np.asarray(ps.path_owner)
    d = np.maximum(np.round(np.asarray(ps.demands)).astype(np.int64), 1)
    cnt = np.bincount(owner, minlength=ps.n_commodities)
    first = np.searchsorted(owner, np.arange(ps.n_commodities))
    ci = np.repeat(np.arange(ps.n_commodities), d)
    fid = np.arange(len(ci), dtype=np.uint32)
    h = flow_hash(src[ci], dst[ci], fid, salt)
    pick = (h % np.maximum(cnt[ci], 1).astype(np.uint32)).astype(np.int64)
    return first[ci] + pick


def ecmp_group_sizes(ps) -> np.ndarray:
    """(K,) distinct equal-cost paths per commodity of an ECMP path system.

    Table 1's per-pair counts: on a random graph most entries are tiny
    (often 1), on a k-ary fat-tree every inter-pod edge-switch pair shows
    exactly ``(k/2)^2``.
    """
    return np.bincount(ps.path_owner, minlength=ps.n_commodities)


def fattree_ecmp_check(ps, ft_k: int) -> dict:
    """Enumerated fat-tree ECMP groups vs the analytic equal-cost counts.

    A k-ary fat-tree offers exactly ``(k/2)^2`` equal-cost paths per
    inter-pod edge-switch pair and ``k/2`` per same-pod pair; edge switches
    are numbered in pod blocks, so ``src // k != dst // k`` separates the
    two classes.  Returns the expected counts, the observed distinct group
    sizes per class, and per-class exactness flags.
    """
    if ps.src is None or ps.dst is None or ps.unrouted is None:
        raise ValueError("fattree_ecmp_check needs a path system with pedigree")
    groups = ecmp_group_sizes(ps)
    kept = ~np.asarray(ps.unrouted)
    src = np.asarray(ps.src)[kept]
    dst = np.asarray(ps.dst)[kept]
    inter = (src // ft_k) != (dst // ft_k)
    exp_inter, exp_same = (ft_k // 2) ** 2, ft_k // 2
    return {
        "expected_inter_pod": exp_inter,
        "expected_same_pod": exp_same,
        "inter_pod_groups": np.unique(groups[inter]),
        "same_pod_groups": np.unique(groups[~inter]),
        "inter_pod_groups_exact": bool(np.all(groups[inter] == exp_inter)),
        "same_pod_groups_exact": bool(np.all(groups[~inter] == exp_same)),
    }
