"""Runtime contract validators for the solver data structures.

Every scale rung of this repo rests on *representation invariants* that no
type system checks: directed-slot ids bounded by ``n_slots`` (which doubles
as the padding sentinel), the batch padding discipline (padded slots carry
infinite capacity == zero inverse, padded path rows belong to a
zero-demand dummy commodity), ``row_map`` injectivity for warm starts, the
canonical (length, lexicographic) tie order that makes delta updates
bit-identical to rebuilds, and the int16 ``INT16_INF`` distance sentinel.
This module checks them *at the boundaries where the structures are made*
— ``build_path_system`` / ``update_path_system`` /
``PathSystemBatch.from_systems`` / ``from_shared`` / ``sim.simulate`` —
behind ``REPRO_CHECK=1`` (see ``repro_torch.env``; the tier-1 test suite
turns it on by default via ``conftest.py``).

Port copy of the part of ``repro/analysis/contracts.py`` that the ported
paths call (numpy only, unchanged): the path-system, hop-matrix, batch,
built-batch (CT-build), simulator-state (CT-sim) and live-event carry
migration checks.

Validators are pure numpy and duck-typed over the dataclasses, so this
module imports none of the solver modules (they import *us* at module
level) and can run on hand-built fixtures.  A violated contract raises
``ContractViolation`` (an ``AssertionError`` subclass) whose message names
the producing boundary, the field, and the first offending index.
"""

from __future__ import annotations

import numpy as np

from .. import env

__all__ = [
    "ContractViolation",
    "check_built_batch",
    "check_carry_migration",
    "check_hop_matrix",
    "check_path_system",
    "check_path_system_batch",
    "check_sim_state",
    "checks_enabled",
    "set_check_enabled",
]

#: Canonical int16 unreachable sentinel.  Duplicated from ``core.metrics``
#: (exactly as ``kernels.ops`` does) so this module stays import-cycle-free:
#: ``core.routing`` imports us at module level.
INT16_INF = np.int16(32767)

_enabled = bool(env.read("REPRO_CHECK"))


class ContractViolation(AssertionError):
    """A solver-boundary representation invariant does not hold."""


def checks_enabled() -> bool:
    """True when boundary validation is active (``REPRO_CHECK=1``)."""
    return _enabled


def set_check_enabled(flag: bool) -> bool:
    """Toggle boundary validation in-process; returns the previous value.

    The env var only sets the initial state (read once at import, the
    ``repro.env`` discipline); tests flip this to exercise both modes
    without re-importing.
    """
    global _enabled
    prev, _enabled = _enabled, bool(flag)
    return prev


def _fail(name: str, msg: str):
    raise ContractViolation(f"{name}: {msg}")


# --------------------------------------------------------------------------- #
# PathSystem
# --------------------------------------------------------------------------- #


def _decode_rows(pe, plen, edges, E):
    """Per-row (tail, head) node arrays for the directed-slot convention:
    slot e is edges[e] traversed low->high, slot e + E high->low."""
    eid = np.where(pe < E, pe, pe - E)
    eid = np.clip(eid, 0, max(len(edges) - 1, 0))
    u = edges[eid, 0]
    v = edges[eid, 1]
    fwd = pe < E
    tail = np.where(fwd, u, v)
    head = np.where(fwd, v, u)
    return tail, head


def check_path_system(ps, top=None, *, name: str = "path_system",
                      max_decode_rows: int = 4096) -> None:
    """Validate a ``PathSystem``'s representation invariants.

    With ``top`` given, additionally decodes a bounded prefix of path rows
    back to node sequences and checks hop chaining, simplicity, endpoint
    agreement with the commodity pedigree, and the canonical
    (length, lexicographic-node-sequence) tie order that the delta ==
    rebuild bit-exactness guarantee rests on.
    """
    E = int(ps.n_edges)
    caps = np.asarray(ps.capacities)
    S = len(caps)
    if S != 2 * E:
        _fail(name, f"capacities has {S} slots but n_edges={E} implies "
                    f"n_slots=2E={2 * E} (directed-slot convention)")
    if caps.size and (not np.all(np.isfinite(caps)) or np.any(caps <= 0)):
        i = int(np.argmin(np.where(np.isfinite(caps), caps, -np.inf)))
        _fail(name, f"capacities must be positive and finite; "
                    f"capacities[{i}]={caps[i]}")

    pe = np.asarray(ps.path_edges)
    plen = np.asarray(ps.path_len)
    owner = np.asarray(ps.path_owner)
    if pe.ndim != 2:
        _fail(name, f"path_edges must be rank 2, got shape {pe.shape}")
    P, L = pe.shape
    if len(plen) != P or len(owner) != P:
        _fail(name, f"path_len/path_owner must have one entry per path row: "
                    f"P={P}, len(path_len)={len(plen)}, "
                    f"len(path_owner)={len(owner)}")
    if np.any(plen < 0) or np.any(plen > L):
        p = int(np.argmax((plen < 0) | (plen > L)))
        _fail(name, f"path_len[{p}]={plen[p]} outside [0, Lmax={L}]")

    hop = np.arange(L)[None, :] < plen[:, None]
    bad = hop & ((pe < 0) | (pe >= S))
    if bad.any():
        p, j = map(int, np.argwhere(bad)[0])
        _fail(name, f"path_edges[{p}, {j}]={pe[p, j]} is not a directed slot "
                    f"id in [0, n_slots={S})")
    bad_pad = ~hop & (pe != S)
    if bad_pad.any():
        p, j = map(int, np.argwhere(bad_pad)[0])
        _fail(name, f"path_edges[{p}, {j}]={pe[p, j]} beyond "
                    f"path_len[{p}]={plen[p]} must hold the padding sentinel "
                    f"n_slots={S}")

    K = int(ps.n_commodities)
    if P and (np.any(owner < 0) or np.any(owner >= K)):
        p = int(np.argmax((owner < 0) | (owner >= K)))
        _fail(name, f"path_owner[{p}]={owner[p]} outside "
                    f"[0, n_commodities={K})")
    if P and np.any(np.diff(owner) < 0):
        p = int(np.argmax(np.diff(owner) < 0))
        _fail(name, f"path rows must be grouped by commodity in order "
                    f"(canonical layout); path_owner[{p}]={owner[p]} > "
                    f"path_owner[{p + 1}]={owner[p + 1]}")
    if K and (P == 0 or np.any(np.bincount(owner, minlength=K) == 0)):
        missing = (int(np.argmax(np.bincount(owner, minlength=K) == 0))
                   if P else 0)
        _fail(name, f"kept commodity {missing} has no path rows (every "
                    "routed commodity must keep >= 1 path)")

    dem = np.asarray(ps.demands)
    if len(dem) != K:
        _fail(name, f"demands has {len(dem)} entries for n_commodities={K}")
    if dem.size and (not np.all(np.isfinite(dem)) or np.any(dem < 0)):
        i = int(np.argmin(np.where(np.isfinite(dem), dem, -np.inf)))
        _fail(name, f"demands must be finite and >= 0; demands[{i}]={dem[i]}")

    ksrc = kdst = None
    if ps.unrouted is not None and ps.src is not None and ps.dst is not None:
        unrouted = np.asarray(ps.unrouted)
        src = np.asarray(ps.src)
        dst = np.asarray(ps.dst)
        if not (len(unrouted) == len(src) == len(dst)):
            _fail(name, f"unrouted/src/dst length mismatch: "
                        f"{len(unrouted)}/{len(src)}/{len(dst)}")
        if int((~unrouted).sum()) != K:
            _fail(name, f"n_commodities={K} but {int((~unrouted).sum())} "
                        "commodities are marked routed in `unrouted`")
        ksrc = src[~unrouted]
        kdst = dst[~unrouted]
        zero_len = P and np.any(plen == 0)
        if zero_len:
            zp = np.flatnonzero(plen == 0)
            k0 = owner[zp]
            if np.any(ksrc[k0] != kdst[k0]):
                p = int(zp[np.argmax(ksrc[k0] != kdst[k0])])
                _fail(name, f"path row {p} has path_len=0 but its commodity "
                            f"{owner[p]} is not a src==dst self-pair")

    if ps.row_map is not None:
        rm = np.asarray(ps.row_map)
        if len(rm) != P:
            _fail(name, f"row_map has {len(rm)} entries for P={P} rows")
        if rm.size and np.any(rm < -1):
            p = int(np.argmax(rm < -1))
            _fail(name, f"row_map[{p}]={rm[p]} < -1 (must be -1 for fresh "
                        "rows or a predecessor row index)")
        live = rm[rm >= 0]
        if live.size != len(np.unique(live)):
            vals, cnt = np.unique(live, return_counts=True)
            _fail(name, f"row_map must map injectively onto predecessor "
                        f"rows; predecessor row {int(vals[np.argmax(cnt > 1)])}"
                        " is claimed by multiple rows (warm starts would "
                        "double-count its rate)")

    if top is None or P == 0:
        return

    # ---- decode a bounded prefix and verify geometry + canonical order ---- #
    if int(top.n_edges) != E:
        _fail(name, f"topology has {int(top.n_edges)} edges but "
                    f"ps.n_edges={E}")
    edges = np.asarray(top.edges).reshape(-1, 2)
    n_rows = P
    if n_rows > max_decode_rows:
        # align down to a commodity boundary so the tie-order check never
        # sees a truncated commodity
        n_rows = int(max_decode_rows)
        while n_rows < P and owner[n_rows] == owner[n_rows - 1]:
            n_rows -= 1
    pe_s, plen_s, owner_s = pe[:n_rows], plen[:n_rows], owner[:n_rows]
    hop_s = hop[:n_rows]
    tail, head = _decode_rows(pe_s, plen_s, edges, E)

    both = hop_s[:, :-1] & hop_s[:, 1:]
    broken = both & (head[:, :-1] != tail[:, 1:])
    if broken.any():
        p, j = map(int, np.argwhere(broken)[0])
        _fail(name, f"path row {p} does not chain: hop {j} ends at node "
                    f"{head[p, j]} but hop {j + 1} starts at {tail[p, j + 1]}")

    if ksrc is not None:
        nz = np.flatnonzero(plen_s > 0)
        if nz.size:
            bad_src = tail[nz, 0] != ksrc[owner_s[nz]]
            last = plen_s[nz] - 1
            bad_dst = head[nz, last] != kdst[owner_s[nz]]
            if bad_src.any() or bad_dst.any():
                p = int(nz[np.argmax(bad_src | bad_dst)])
                k = int(owner_s[p])
                _fail(name, f"path row {p} runs {tail[p, 0]}->"
                            f"{head[p, plen_s[p] - 1]} but commodity {k} is "
                            f"({ksrc[k]}, {kdst[k]})")

    # simplicity + canonical (length, lex) tie order, commodity by commodity
    prev_key = None
    prev_owner = -1
    for p in range(n_rows):
        ln = int(plen_s[p])
        nodes = ([int(tail[p, 0])] + [int(x) for x in head[p, :ln]]
                 if ln else [])
        if len(set(nodes)) != len(nodes):
            _fail(name, f"path row {p} revisits a node (paths must be "
                        f"simple): {nodes}")
        if ksrc is not None and ln:
            k = int(owner_s[p])
            # src > dst commodities store the reversed canonical-pair
            # enumeration; compare in canonical orientation
            seq = nodes[::-1] if int(ksrc[k]) > int(kdst[k]) else nodes
        else:
            seq = nodes
        key = (ln, seq)
        if int(owner_s[p]) == prev_owner and key < prev_key:
            _fail(name, f"path rows of commodity {prev_owner} are not in "
                        f"canonical (length, lexicographic) order at row "
                        f"{p}: {key} sorts before {prev_key} (delta == "
                        "rebuild bit-exactness depends on this order)")
        prev_key, prev_owner = key, int(owner_s[p])


def check_hop_matrix(dist, n: int, *, name: str = "hop_matrix") -> None:
    """Validate the canonical int16 APSP hop matrix representation."""
    d = np.asarray(dist)
    if d.dtype != np.int16:
        _fail(name, f"hop matrix must be int16 (canonical representation), "
                    f"got {d.dtype}")
    if d.shape != (n, n):
        _fail(name, f"hop matrix shape {d.shape} != ({n}, {n})")
    if n == 0:
        return
    if np.any(np.diag(d) != 0):
        i = int(np.argmax(np.diag(d) != 0))
        _fail(name, f"dist[{i}, {i}]={d[i, i]} != 0")
    if not np.array_equal(d, d.T):
        i, j = map(int, np.argwhere(d != d.T)[0])
        _fail(name, f"hop matrix must be symmetric: dist[{i}, {j}]="
                    f"{d[i, j]} != dist[{j}, {i}]={d[j, i]}")
    off = d[~np.eye(n, dtype=bool)]
    bad = (off < 1) | ((off >= n) & (off != INT16_INF))
    if bad.any():
        _fail(name, f"off-diagonal hop counts must be in [1, n) or the "
                    f"INT16_INF={int(INT16_INF)} sentinel; found "
                    f"{int(off[np.argmax(bad)])}")


# --------------------------------------------------------------------------- #
# PathSystemBatch
# --------------------------------------------------------------------------- #


def check_path_system_batch(batch, *, name: str = "path_system_batch",
                            max_instances: int = 16) -> None:
    """Validate a ``PathSystemBatch``'s padding/masking discipline.

    Padded slots must be *infinite capacity* (``inv_cap == 0`` exactly,
    masked by ``slot_valid``), padded path rows must belong to the
    zero-demand dummy commodity and hold each instance's own ``n_slots``
    sentinel, and the gather fan-in tables must point back at hops of the
    slot/commodity they index.  Per-instance content is compared against
    the first ``max_instances`` source systems (the rest are shape-checked
    only, keeping the validator O(batch envelope)).
    """
    name = f"path_system_batch[{name}]"
    pe = np.asarray(batch.path_edges)
    owner = np.asarray(batch.path_owner)
    dem = np.asarray(batch.demands)
    inv = np.asarray(batch.inv_cap)
    sval = np.asarray(batch.slot_valid)
    n_paths = np.asarray(batch.n_paths)
    stacked = not batch.shared

    if np.any(inv[~sval] != 0.0):
        idx = tuple(map(int, np.argwhere((inv != 0.0) & ~sval)[0]))
        _fail(name, f"padded slot {idx} must carry infinite capacity: "
                    f"inv_cap{list(idx)}={inv[idx]} != 0 (a finite-capacity "
                    "phantom slot would congest the solver)")
    if np.any(~np.isfinite(inv)) or np.any(inv[sval] <= 0.0):
        idx = tuple(map(int, np.argwhere(
            ~np.isfinite(inv) | (sval & (inv <= 0.0)))[0]))
        _fail(name, f"valid slot {idx} must have finite positive inv_cap; "
                    f"got {inv[idx]}")

    if stacked:
        if pe.ndim != 3 or owner.ndim != 2:
            _fail(name, f"stacked batch needs rank-3 path_edges / rank-2 "
                        f"path_owner; got {pe.shape} / {owner.shape}")
        B, P, L = pe.shape
        K = dem.shape[1] - 1
        if np.any(dem[:, K] != 0.0):
            i = int(np.argmax(dem[:, K] != 0.0))
            _fail(name, f"dummy commodity column must be zero-demand; "
                        f"demands[{i}, {K}]={dem[i, K]}")
        if np.any(owner < 0) or np.any(owner > K):
            i, p = map(int, np.argwhere((owner < 0) | (owner > K))[0])
            _fail(name, f"path_owner[{i}, {p}]={owner[i, p]} outside "
                        f"[0, dummy={K}]")
        if np.any(n_paths < 0) or np.any(n_paths > P):
            i = int(np.argmax((n_paths < 0) | (n_paths > P)))
            _fail(name, f"n_paths[{i}]={n_paths[i]} outside [0, P={P}]")
        for i, ps in enumerate(batch.systems[:max_instances]):
            Si = ps.n_slots
            if not (np.all(sval[i, :Si]) and not np.any(sval[i, Si:])):
                _fail(name, f"slot_valid[{i}] must mask exactly the first "
                            f"n_slots={Si} slots")
            if Si and not np.array_equal(
                inv[i, :Si], (1.0 / np.asarray(ps.capacities,
                                               np.float32)).astype(np.float32)
            ):
                _fail(name, f"inv_cap[{i}] does not equal 1/capacities of "
                            f"source system {i}")
            pb = ps.n_paths
            if int(n_paths[i]) != pb:
                _fail(name, f"n_paths[{i}]={int(n_paths[i])} but source "
                            f"system has {pb} paths")
            if np.any(owner[i, pb:] != K):
                p = pb + int(np.argmax(owner[i, pb:] != K))
                _fail(name, f"padded row {p} of instance {i} must belong to "
                            f"the dummy commodity {K}; path_owner[{i}, {p}]="
                            f"{owner[i, p]}")
            if np.any(pe[i, pb:, :] != Si):
                p, j = map(int, np.argwhere(pe[i, pb:, :] != Si)[0])
                _fail(name, f"padded row {pb + p} of instance {i} must hold "
                            f"the instance sentinel n_slots={Si}; "
                            f"path_edges[{i}, {pb + p}, {j}]="
                            f"{pe[i, pb + p, j]}")
            if pb:
                sb = np.asarray(ps.path_edges)
                lb = sb.shape[1]
                if not np.array_equal(pe[i, :pb, :lb], sb):
                    _fail(name, f"instance {i} path_edges differ from its "
                                "source system")
                if np.any(pe[i, :pb, lb:] != Si):
                    _fail(name, f"instance {i} rows must pad columns beyond "
                                f"L={lb} with the sentinel {Si}")
                if not np.array_equal(owner[i, :pb],
                                      np.asarray(ps.path_owner)):
                    _fail(name, f"instance {i} path_owner differs from its "
                                "source system")
            ki = ps.n_commodities
            if not np.array_equal(dem[i, :ki],
                                  np.asarray(ps.demands, np.float32)):
                _fail(name, f"instance {i} demands differ from its source "
                            "system")
            if np.any(dem[i, ki:] != 0.0):
                _fail(name, f"instance {i} demand columns beyond "
                            f"n_commodities={ki} must be zero (padding "
                            "commodities must not attract flow)")
    else:
        ps = batch.systems[0]
        if pe.ndim != 2:
            _fail(name, f"shared batch needs rank-2 path_edges; got "
                        f"{pe.shape}")
        P, L = pe.shape
        if not np.array_equal(pe, np.asarray(ps.path_edges, np.int32)):
            _fail(name, "shared path_edges differ from the source system")
        if dem.ndim != 2 or dem.shape[1] != ps.n_commodities:
            _fail(name, f"shared-batch demands must be "
                        f"(B, {ps.n_commodities}); got {dem.shape}")
        if np.any(~np.isfinite(dem)) or np.any(dem < 0):
            i, k = map(int, np.argwhere(~np.isfinite(dem) | (dem < 0))[0])
            _fail(name, f"demands[{i}, {k}]={dem[i, k]} must be finite and "
                        ">= 0")
        if np.any(n_paths != ps.n_paths):
            _fail(name, "shared batch n_paths must all equal the source "
                        f"system's {ps.n_paths}")

    # gather fan-in tables: every non-sentinel pointer must point back at a
    # hop of the slot (row of the commodity) it is indexed under
    if batch.slot_gather is not None:
        tab = np.asarray(batch.slot_gather)
        flat = (pe.reshape(pe.shape[0], -1) if stacked
                else np.broadcast_to(pe.reshape(-1)[None],
                                     (1, pe.size)))
        tabs = tab if stacked else tab[None]
        PL = flat.shape[1]
        if np.any(tabs < 0) or np.any(tabs > PL):
            idx = tuple(map(int, np.argwhere((tabs < 0) | (tabs > PL))[0]))
            _fail(name, f"slot_gather{list(idx)}={tabs[idx]} outside "
                        f"[0, P*L={PL}]")
        nb = min(tabs.shape[0], max_instances)
        for i in range(nb):
            s_idx, d_idx = np.nonzero(tabs[i] < PL)
            if s_idx.size and np.any(flat[i, tabs[i, s_idx, d_idx]] != s_idx):
                j = int(np.argmax(flat[i, tabs[i, s_idx, d_idx]] != s_idx))
                _fail(name, f"slot_gather[{i}, {int(s_idx[j])}, "
                            f"{int(d_idx[j])}] points at a hop of slot "
                            f"{int(flat[i, tabs[i, s_idx[j], d_idx[j]]])}")
    if batch.owner_gather is not None:
        tab = np.asarray(batch.owner_gather)
        own = owner if stacked else np.broadcast_to(owner[None],
                                                    (1, owner.shape[0]))
        tabs = tab if stacked else tab[None]
        Pmax = own.shape[1]
        if np.any(tabs < 0) or np.any(tabs > Pmax):
            idx = tuple(map(int, np.argwhere((tabs < 0) | (tabs > Pmax))[0]))
            _fail(name, f"owner_gather{list(idx)}={tabs[idx]} outside "
                        f"[0, P={Pmax}]")
        nb = min(tabs.shape[0], max_instances)
        for i in range(nb):
            k_idx, d_idx = np.nonzero(tabs[i] < Pmax)
            if k_idx.size and np.any(own[i, tabs[i, k_idx, d_idx]] != k_idx):
                j = int(np.argmax(own[i, tabs[i, k_idx, d_idx]] != k_idx))
                _fail(name, f"owner_gather[{i}, {int(k_idx[j])}, "
                            f"{int(d_idx[j])}] points at a row of commodity "
                            f"{int(own[i, tabs[i, k_idx[j], d_idx[j]]])}")


def check_built_batch(batch, tops, *, name: str = "build_path_system_batch",
                      max_instances: int = 16) -> None:
    """Validate a directly-constructed batch at the batch-build boundary.

    ``build_path_system_batch`` composes B instances into one enumeration
    pass and assembles the envelope straight from the streamed per-instance
    systems, so the batch-level padding/gather discipline
    (``check_path_system_batch``) AND each member system's own invariants
    — including the canonical (length, lex) tie order that the
    batch == sequential bit-exactness contract (CT-build) rests on — are
    established *here*, not at B separate ``build_path_system`` exits.
    Per-instance decode work is bounded by ``max_instances`` exactly as in
    ``check_path_system_batch``.
    """
    check_path_system_batch(batch, name=name, max_instances=max_instances)
    for i, (ps, top) in enumerate(zip(batch.systems[:max_instances], tops)):
        check_path_system(ps, top, name=f"{name}[instance {i}]")


# --------------------------------------------------------------------------- #
# SimResult
# --------------------------------------------------------------------------- #


def check_sim_state(res, *, name: str = "sim_result") -> None:
    """Validate a ``SimResult``'s accounting invariants.

    Completion counts must reconcile with the FCT histogram, every FCT is
    at least one step, per-commodity delivered volume never exceeds
    admitted volume, per-step throughput totals match per-commodity
    delivered totals (float32-accumulation tolerance), and padded slots
    accumulate exactly zero utilization.
    """
    thr = np.asarray(res.throughput)
    act = np.asarray(res.active)
    T = int(res.n_steps)
    if thr.ndim != 2 or thr.shape[0] != T or act.shape != thr.shape:
        _fail(name, f"throughput/active must be (n_steps={T}, B); got "
                    f"{thr.shape} / {act.shape}")
    B = thr.shape[1]
    if not (res.dt > 0):
        _fail(name, f"dt={res.dt} must be > 0")
    if np.any(thr < 0) or np.any(~np.isfinite(thr)):
        t, b = map(int, np.argwhere((thr < 0) | ~np.isfinite(thr))[0])
        _fail(name, f"throughput[{t}, {b}]={thr[t, b]} must be finite "
                    ">= 0")
    if np.any(act < 0):
        t, b = map(int, np.argwhere(act < 0)[0])
        _fail(name, f"active[{t}, {b}]={act[t, b]} must be >= 0")

    hist = np.asarray(res.fct_hist)
    cnt = np.asarray(res.fct_count)
    fct = np.asarray(res.fct_sum)
    if hist.shape[0] != B or cnt.shape != (B,) or fct.shape != (B,):
        _fail(name, f"fct_hist/fct_count/fct_sum batch dims must be B={B}; "
                    f"got {hist.shape} / {cnt.shape} / {fct.shape}")
    hsum = hist.sum(axis=1, dtype=np.float64)
    if np.any(np.abs(hsum - cnt) > 0.5):
        b = int(np.argmax(np.abs(hsum - cnt) > 0.5))
        _fail(name, f"fct_hist[{b}] sums to {hsum[b]} but fct_count[{b}]="
                    f"{cnt[b]} (every completion must land in exactly one "
                    "bin)")
    if np.any(cnt < 0) or np.any(~np.isfinite(fct)) or np.any(fct < 0):
        b = int(np.argmax((cnt < 0) | ~np.isfinite(fct) | (fct < 0)))
        _fail(name, f"fct_count[{b}]={cnt[b]} / fct_sum[{b}]={fct[b]} must "
                    "be finite >= 0")
    min_sum = res.dt * cnt.astype(np.float64)
    if np.any(fct < min_sum * (1.0 - 1e-5) - 1e-6):
        b = int(np.argmax(fct < min_sum * (1.0 - 1e-5) - 1e-6))
        _fail(name, f"fct_sum[{b}]={fct[b]} < dt * fct_count[{b}]="
                    f"{min_sum[b]}: a flow cannot complete in under one "
                    "step")

    deliv = np.asarray(res.comm_delivered)
    off = np.asarray(res.comm_offered)
    if deliv.shape != off.shape or deliv.shape[0] != B:
        _fail(name, f"comm_delivered/comm_offered must be (B={B}, K+1); "
                    f"got {deliv.shape} / {off.shape}")
    if np.any(deliv < 0) or np.any(off < 0) or \
            np.any(~np.isfinite(deliv)) or np.any(~np.isfinite(off)):
        idx = tuple(map(int, np.argwhere(
            (deliv < 0) | (off < 0) | ~np.isfinite(deliv)
            | ~np.isfinite(off))[0]))
        _fail(name, f"commodity volumes at {idx} must be finite >= 0")
    slack = 1e-3 * np.maximum(off, 1.0)
    if np.any(deliv > off + slack):
        i, k = map(int, np.argwhere(deliv > off + slack)[0])
        _fail(name, f"comm_delivered[{i}, {k}]={deliv[i, k]} exceeds "
                    f"comm_offered[{i}, {k}]={off[i, k]}: the sim delivered "
                    "volume that was never admitted")

    tot_thr = thr.sum(axis=0, dtype=np.float64)
    tot_del = deliv.sum(axis=1, dtype=np.float64)
    budget = 1e-3 * np.maximum(tot_del, 1.0)
    if np.any(np.abs(tot_thr - tot_del) > budget):
        b = int(np.argmax(np.abs(tot_thr - tot_del) > budget))
        _fail(name, f"instance {b}: per-step throughput total "
                    f"{tot_thr[b]} != per-commodity delivered total "
                    f"{tot_del[b]} (volume accounting broke)")

    drops = np.asarray(res.drops)
    admitted = np.asarray(res.admitted)
    if drops.shape != (B,) or admitted.shape != (B,):
        _fail(name, f"drops/admitted must be (B={B},); got {drops.shape} / "
                    f"{admitted.shape}")
    if np.any(drops < 0) or np.any(admitted < 0):
        b = int(np.argmax((drops < 0) | (admitted < 0)))
        _fail(name, f"drops[{b}]={drops[b]} / admitted[{b}]={admitted[b]} "
                    "must be >= 0")
    if np.any(cnt > admitted):
        b = int(np.argmax(cnt > admitted))
        _fail(name, f"fct_count[{b}]={cnt[b]} completed flows > "
                    f"admitted[{b}]={admitted[b]}")

    util = np.asarray(res.util_sum)
    sval = np.asarray(res.slot_valid)
    if util.shape != sval.shape:
        _fail(name, f"util_sum {util.shape} / slot_valid {sval.shape} "
                    "shape mismatch")
    if np.any(util[~sval] != 0.0):
        idx = tuple(map(int, np.argwhere((util != 0.0) & ~sval)[0]))
        _fail(name, f"padded slot {idx} accumulated utilization "
                    f"{util[idx]} != 0 (inv_cap masking broke)")
    if np.any(util < -1e-6) or np.any(~np.isfinite(util)):
        idx = tuple(map(int, np.argwhere(
            (util < -1e-6) | ~np.isfinite(util))[0]))
        _fail(name, f"util_sum at {idx} must be finite >= 0")

    # ---- blackhole + volume conservation (guarded with getattr so
    # hand-built fixtures predating the event engine stay valid) ----------- #
    bh = getattr(res, "blackholed", None)
    bh_tot = getattr(res, "blackholed_total", None)
    inflight = getattr(res, "inflight", None)
    if bh is None or bh_tot is None or inflight is None:
        return
    bh = np.asarray(bh)
    bh_tot = np.asarray(bh_tot)
    inflight = np.asarray(inflight)
    if bh.shape != thr.shape or bh_tot.shape != (B,) or \
            inflight.shape != (B,):
        _fail(name, f"blackholed must be {thr.shape}, blackholed_total/"
                    f"inflight (B={B},); got {bh.shape} / {bh_tot.shape} / "
                    f"{inflight.shape}")
    if np.any(bh < 0) or np.any(~np.isfinite(bh)):
        t, b = map(int, np.argwhere((bh < 0) | ~np.isfinite(bh))[0])
        _fail(name, f"blackholed[{t}, {b}]={bh[t, b]} must be finite >= 0")
    if np.any(bh_tot < 0) or np.any(~np.isfinite(bh_tot)) or \
            np.any(inflight < 0) or np.any(~np.isfinite(inflight)):
        b = int(np.argmax((bh_tot < 0) | ~np.isfinite(bh_tot)
                          | (inflight < 0) | ~np.isfinite(inflight)))
        _fail(name, f"blackholed_total[{b}]={bh_tot[b]} / inflight[{b}]="
                    f"{inflight[b]} must be finite >= 0")
    # per-step blackhole totals never exceed the running total (the total
    # additionally counts volume killed outright at event boundaries)
    step_bh = bh.sum(axis=0, dtype=np.float64)
    bh_budget = 1e-3 * np.maximum(bh_tot, 1.0)
    if np.any(step_bh > bh_tot + bh_budget):
        b = int(np.argmax(step_bh > bh_tot + bh_budget))
        _fail(name, f"instance {b}: per-step blackholed sum {step_bh[b]} "
                    f"exceeds blackholed_total {bh_tot[b]}")
    # conservation: every admitted byte is delivered, still in flight, or
    # blackholed.  (drops count arrivals never admitted, so they carry no
    # volume in this ledger.)
    tot_off = off.sum(axis=1, dtype=np.float64)
    lhs = tot_del + bh_tot.astype(np.float64) + inflight.astype(np.float64)
    budget = 1e-3 * np.maximum(tot_off, 1.0)
    if np.any(np.abs(tot_off - lhs) > budget):
        b = int(np.argmax(np.abs(tot_off - lhs) > budget))
        _fail(name, f"instance {b}: offered {tot_off[b]} != delivered "
                    f"{tot_del[b]} + blackholed {bh_tot[b]} + in-flight "
                    f"{inflight[b]} (volume conservation broke)")


# --------------------------------------------------------------------------- #
# segmented-scan carry migration (repro_torch.sim.events)
# --------------------------------------------------------------------------- #


def check_carry_migration(
    row_old, row_new, rem_old, rem_new, age_old, age_new, fid_old, fid_new,
    hold_old, hold_new, fwd_maps, p_old: int, p_new: int, lag: int,
    *, name: str = "carry_migration",
) -> None:
    """Validate one event-boundary migration of the sim scan carry.

    ``fwd_maps[i]`` maps instance ``i``'s old path rows to new rows (-1 =
    vanished) — the inverse of the composed ``row_map`` pedigree, so its
    injectivity here IS the row_map-injectivity contract on migrated
    carries.  Slot-level checks: empty slots stay empty, surviving flows
    keep row (through ``fwd``), ``rem``/``age``/``fid`` bit-exactly, and
    every non-surviving flow is either killed (freed slot, zero state) or
    re-selected (state preserved, ``hold`` within the detection lag).
    """
    row_old = np.asarray(row_old)
    row_new = np.asarray(row_new)
    if row_old.shape != row_new.shape:
        _fail(name, f"slot table shape changed: {row_old.shape} -> "
                    f"{row_new.shape}")
    B = row_old.shape[0]
    if len(fwd_maps) != B:
        _fail(name, f"fwd_maps has {len(fwd_maps)} entries for B={B}")
    rem_old, rem_new = np.asarray(rem_old), np.asarray(rem_new)
    age_old, age_new = np.asarray(age_old), np.asarray(age_new)
    fid_old, fid_new = np.asarray(fid_old), np.asarray(fid_new)
    hold_old, hold_new = np.asarray(hold_old), np.asarray(hold_new)
    for i in range(B):
        fwd = np.asarray(fwd_maps[i])
        live = fwd[fwd >= 0]
        if live.size != len(np.unique(live)):
            vals, cnts = np.unique(live, return_counts=True)
            _fail(name, f"instance {i}: fwd map is not injective — new row "
                        f"{int(vals[np.argmax(cnts > 1)])} claimed by "
                        "multiple old rows (two flows would share a path "
                        "row's identity)")
        if live.size and (live.min() < 0 or live.max() >= p_new):
            _fail(name, f"instance {i}: fwd map targets outside "
                        f"[0, {p_new})")
        empty = row_old[i] == p_old
        if np.any(row_new[i][empty] != p_new):
            f = int(np.flatnonzero(empty & (row_new[i] != p_new))[0])
            _fail(name, f"instance {i} slot {f}: empty slot materialized a "
                        f"flow (row {int(row_new[i][f])})")
        act = ~empty
        if len(fwd):
            surv = act & (fwd[np.clip(row_old[i], 0, len(fwd) - 1)] >= 0)
        else:
            surv = np.zeros_like(act)
        if np.any(surv):
            sf = np.flatnonzero(surv)
            if np.any(row_new[i][sf] != fwd[row_old[i][sf]]):
                f = int(sf[np.argmax(row_new[i][sf]
                                     != fwd[row_old[i][sf]])])
                _fail(name, f"instance {i} slot {f}: surviving flow moved "
                            f"to row {int(row_new[i][f])} != fwd["
                            f"{int(row_old[i][f])}]="
                            f"{int(fwd[row_old[i][f]])}")
            same = (
                np.array_equal(rem_new[i][sf], rem_old[i][sf])
                and np.array_equal(age_new[i][sf], age_old[i][sf])
                and np.array_equal(fid_new[i][sf], fid_old[i][sf])
                and np.array_equal(hold_new[i][sf], hold_old[i][sf])
            )
            if not same:
                _fail(name, f"instance {i}: surviving flows must keep "
                            "rem/age/fid/hold bit-exactly")
        moved = act & ~surv
        for f in np.flatnonzero(moved):
            if row_new[i][f] == p_new:  # killed
                if rem_new[i][f] != 0.0 or hold_new[i][f] != 0:
                    _fail(name, f"instance {i} slot {f}: killed flow must "
                                f"zero its state (rem={rem_new[i][f]}, "
                                f"hold={int(hold_new[i][f])})")
            else:  # re-selected
                if not (0 <= row_new[i][f] < p_new):
                    _fail(name, f"instance {i} slot {f}: re-selected row "
                                f"{int(row_new[i][f])} outside [0, {p_new})")
                if rem_new[i][f] != rem_old[i][f] or \
                        age_new[i][f] != age_old[i][f] or \
                        fid_new[i][f] != fid_old[i][f]:
                    _fail(name, f"instance {i} slot {f}: re-selected flow "
                                "must preserve rem/age/fid bit-exactly")
                hi = max(int(lag), int(hold_old[i][f]))
                if not (0 <= hold_new[i][f] <= hi):
                    _fail(name, f"instance {i} slot {f}: hold="
                                f"{int(hold_new[i][f])} outside [0, {hi}] "
                                f"(lag={int(lag)})")
