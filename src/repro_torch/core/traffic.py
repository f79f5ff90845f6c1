"""Traffic models (paper §4 "Evaluation methodology").

The paper's workhorse is *random permutation traffic*: every server sends at
full line rate to exactly one other server and receives from exactly one
(a uniform-random permutation with no fixed points).  Server-level demands are
aggregated to switch-level commodities; pairs landing on the same switch never
touch the network and are dropped (trivially satisfied at full rate).

Port copy of ``repro/core/traffic.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import obs
from .topology import Topology

__all__ = [
    "Commodities",
    "random_permutation_traffic",
    "all_to_all_traffic",
    "random_server_permutation",
    "extend_server_permutation",
    "permutation_commodities",
    "union_commodities",
]


@dataclasses.dataclass
class Commodities:
    """Switch-level demands: commodity i ships ``demand[i]`` from src to dst."""

    src: np.ndarray  # (K,) switch ids
    dst: np.ndarray  # (K,) switch ids
    demand: np.ndarray  # (K,) float, in units of server line rate
    n_flows: int  # server-level flow count (incl. same-switch trivial flows)

    @property
    def k(self) -> int:
        return len(self.src)

    def total_demand(self) -> float:
        return float(self.demand.sum())


def _server_to_switch(top: Topology) -> np.ndarray:
    """(n_servers,) switch id hosting each server."""
    return np.repeat(np.arange(top.n_switches), top.servers_per_switch)


def random_server_permutation(
    n_servers: int, seed: int | np.random.Generator = 0
) -> np.ndarray:
    """Uniform random server permutation with fixed points removed."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    if n_servers < 2:
        raise ValueError("need at least two servers for permutation traffic")
    perm = rng.permutation(n_servers)
    # Fix fixed points by cyclic shift among them (keeps permutation uniform
    # enough; the paper just requires "sends to a single other server").
    fixed = np.flatnonzero(perm == np.arange(n_servers))
    if len(fixed) == 1:
        other = (fixed[0] + 1) % n_servers
        perm[fixed[0]], perm[other] = perm[other], perm[fixed[0]]
    elif len(fixed) > 1:
        perm[fixed] = perm[np.roll(fixed, 1)]
    return perm


@obs.spanned("traffic/extend_permutation")
def extend_server_permutation(
    perm: np.ndarray, n_servers: int, seed: int | np.random.Generator = 0
) -> np.ndarray:
    """Grow a server permutation to ``n_servers`` by uniform cycle insertion.

    The incremental-expansion workload (paper §4.2): each new server splices
    into the cycle structure after a uniformly chosen existing server
    (``P[new] = P[z]; P[z] = new`` — the classical sequential construction of
    a uniform permutation, minus the fixed-point option, so no new fixed
    points appear).  Each insertion redirects exactly one existing server,
    so consecutive traffic matrices differ in O(new servers) commodities —
    which is what lets ``routing.update_path_system`` splice cached paths
    for the rest.
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    m = len(perm)
    if n_servers < m:
        raise ValueError("permutation cannot shrink; regenerate instead")
    out = np.concatenate([perm, np.arange(m, n_servers)])
    for x in range(m, n_servers):
        z = int(rng.integers(0, x))
        out[x] = out[z]
        out[z] = x
    return out


@obs.spanned("traffic/commodities")
def permutation_commodities(top: Topology, perm: np.ndarray) -> Commodities:
    """Aggregate a server-level permutation to switch-level commodities."""
    host = _server_to_switch(top)
    if len(perm) != len(host):
        raise ValueError(
            f"permutation covers {len(perm)} servers, topology hosts {len(host)}"
        )
    src_sw = host
    dst_sw = host[perm]
    cross = src_sw != dst_sw
    pair = src_sw[cross] * top.n_switches + dst_sw[cross]
    uniq, counts = np.unique(pair, return_counts=True)
    return Commodities(
        src=(uniq // top.n_switches).astype(np.int64),
        dst=(uniq % top.n_switches).astype(np.int64),
        demand=counts.astype(np.float64),
        n_flows=len(perm),
    )


def union_commodities(
    top: Topology, perms: "list[np.ndarray]"
) -> tuple[Commodities, list[np.ndarray]]:
    """Union commodity set of several server permutations + per-epoch demands.

    The churn workloads of ``repro.sim`` re-draw permutation traffic every
    epoch but must route ONCE (a jitted sim scan cannot re-enumerate paths
    mid-flight): the union of the epochs' switch-pair commodities is routed
    up front, and each epoch re-weights demand over that union.  Returns
    ``(union, per_epoch)`` where ``union.demand`` is the per-pair maximum
    across epochs (the routing-relevant envelope) and ``per_epoch[e]`` is
    epoch e's demand in union commodity order (zero where unused).
    """
    if not perms:
        raise ValueError("union_commodities needs at least one permutation")
    comms = [permutation_commodities(top, p) for p in perms]
    n = top.n_switches
    keys = np.unique(np.concatenate([c.src * n + c.dst for c in comms]))
    dem = np.zeros(len(keys))
    per_epoch = []
    for c in comms:
        e = np.zeros(len(keys))
        e[np.searchsorted(keys, c.src * n + c.dst)] = c.demand
        np.maximum(dem, e, out=dem)
        per_epoch.append(e)
    union = Commodities(
        src=(keys // n).astype(np.int64),
        dst=(keys % n).astype(np.int64),
        demand=dem,
        n_flows=comms[0].n_flows,
    )
    return union, per_epoch


def random_permutation_traffic(
    top: Topology, seed: int | np.random.Generator = 0
) -> Commodities:
    """Uniform random derangement of servers, aggregated per switch pair."""
    n = int(top.servers_per_switch.sum())
    return permutation_commodities(top, random_server_permutation(n, seed))


def all_to_all_traffic(top: Topology) -> Commodities:
    """Uniform all-to-all at aggregate rate 1 per server (stress benchmark)."""
    host_counts = top.servers_per_switch.astype(np.float64)
    n_srv = host_counts.sum()
    src, dst, dem = [], [], []
    for i in range(top.n_switches):
        if host_counts[i] == 0:
            continue
        for j in range(top.n_switches):
            if i == j or host_counts[j] == 0:
                continue
            src.append(i)
            dst.append(j)
            # each server spreads rate 1 over all other servers
            dem.append(host_counts[i] * host_counts[j] / max(n_srv - 1, 1))
    return Commodities(
        np.asarray(src, dtype=np.int64),
        np.asarray(dst, dtype=np.int64),
        np.asarray(dem, dtype=np.float64),
        n_flows=int(n_srv),
    )
