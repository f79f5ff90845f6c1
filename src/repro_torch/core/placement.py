"""Physical layout, cabling, and locality-restricted Jellyfish (paper §6).

Two deliverables from the paper's §6:

* ``localized_jellyfish`` — the 2-layer random graph of §6.3 / Fig 12: each
  switch lives in a pod (container); ``local_links`` of its r network ports
  may only connect within the pod, the remaining ``r - local_links`` only
  across pods.  Fig 12's claim: with 5 of 8 links localized the throughput
  loss is ~5%, while the fraction of expensive inter-pod cables drops 59%.
* ``CablePlan`` — cable-length accounting for a 2D rack floor plan with a
  central switch-cluster (§6.1): counts cables, measures Manhattan lengths,
  and classifies electrical (<10 m) vs optical, reproducing the cabling-cost
  arguments of §6.

Port copy of ``repro/core/placement.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = ["localized_jellyfish", "CablePlan", "plan_cables"]


def localized_jellyfish(
    n_pods: int,
    switches_per_pod: int,
    k_ports: int,
    r_net: int,
    local_links: int,
    seed: int | np.random.Generator = 0,
    name: str | None = None,
) -> Topology:
    """2-layer Jellyfish: ``local_links`` ports wire intra-pod, rest inter-pod."""
    if local_links > r_net:
        raise ValueError("local_links cannot exceed network degree")
    if local_links >= switches_per_pod:
        raise ValueError("local degree must be < switches per pod (simple graph)")
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    n = n_pods * switches_per_pod
    pod = np.arange(n) // switches_per_pod
    glob = r_net - local_links

    free_local = np.full(n, local_links, dtype=np.int64)
    free_global = np.full(n, glob, dtype=np.int64)
    nbrs: list[set[int]] = [set() for _ in range(n)]
    edges: set[tuple[int, int]] = set()

    def try_add(u: int, v: int, local: bool) -> bool:
        if u == v or v in nbrs[u]:
            return False
        edges.add((min(u, v), max(u, v)))
        nbrs[u].add(v)
        nbrs[v].add(u)
        if local:
            free_local[u] -= 1
            free_local[v] -= 1
        else:
            free_global[u] -= 1
            free_global[v] -= 1
        return True

    # local matching within each pod
    for p in range(n_pods):
        members = np.arange(p * switches_per_pod, (p + 1) * switches_per_pod)
        stall = 0
        while stall < 300:
            cand = members[free_local[members] > 0]
            if len(cand) < 2:
                break
            u, v = rng.choice(cand, size=2, replace=False)
            if try_add(int(u), int(v), True):
                stall = 0
            else:
                stall += 1
    # global matching across pods
    stall = 0
    while stall < 600:
        cand = np.flatnonzero(free_global > 0)
        if len(cand) < 2:
            break
        u, v = rng.choice(cand, size=2, replace=False)
        u, v = int(u), int(v)
        if pod[u] == pod[v]:
            stall += 1
            continue
        if try_add(u, v, False):
            stall = 0
        else:
            stall += 1

    top = Topology.regular(
        n,
        k_ports,
        r_net,
        sorted(edges),
        name=name or f"jellyfish-2layer(pods={n_pods},local={local_links}/{r_net})",
        kind="jellyfish-localized",
        pods=n_pods,
        switches_per_pod=switches_per_pod,
        local_links=local_links,
    )
    top.validate()
    top.meta["pod_of"] = pod
    return top


@dataclasses.dataclass
class CablePlan:
    n_cables: int
    n_server_cables: int
    mean_length_m: float
    max_length_m: float
    n_optical: int  # cables >= 10 m
    n_bundles: int
    local_fraction: float  # fraction of switch-switch cables intra-pod

    def summary(self) -> str:
        return (
            f"cables={self.n_cables} (+{self.n_server_cables} server) "
            f"len[mean/max]={self.mean_length_m:.1f}/{self.max_length_m:.1f}m "
            f"optical={self.n_optical} bundles={self.n_bundles} "
            f"local={self.local_fraction:.0%}"
        )


def plan_cables(
    top: Topology,
    rack_pitch_m: float = 0.8,
    cluster_center: bool = True,
) -> CablePlan:
    """Cable accounting for a square 2D floor plan (paper §6.1 layout).

    Server racks form a square grid; all switches sit in a central
    switch-cluster when ``cluster_center`` (the paper's optimization), else
    each switch sits with its rack.  Lengths are Manhattan distances.
    """
    n = top.n_switches
    side = int(np.ceil(np.sqrt(n)))
    xy = np.stack([np.arange(n) % side, np.arange(n) // side], axis=1) * rack_pitch_m
    center = xy.mean(axis=0)
    pod_of = top.meta.get("pod_of")

    if cluster_center:
        sw_pos = np.tile(center, (n, 1))
    else:
        sw_pos = xy

    lengths = []
    local = 0
    for u, v in top.edges:
        d = float(np.abs(sw_pos[u] - sw_pos[v]).sum())
        lengths.append(d)
        if pod_of is not None and pod_of[u] == pod_of[v]:
            local += 1
    # server cables: rack position to its switch position
    srv_lengths = []
    for i in range(n):
        for _ in range(int(top.servers_per_switch[i])):
            srv_lengths.append(float(np.abs(xy[i] - sw_pos[i]).sum()))
    lengths = np.asarray(lengths) if lengths else np.zeros(1)
    nb = n if cluster_center else max(1, top.n_edges // 50)
    return CablePlan(
        n_cables=top.n_edges,
        n_server_cables=len(srv_lengths),
        mean_length_m=float(np.mean(np.concatenate([lengths, srv_lengths])))
        if srv_lengths
        else float(lengths.mean()),
        max_length_m=float(max(lengths.max(), max(srv_lengths, default=0.0))),
        n_optical=int((lengths >= 10.0).sum() + (np.asarray(srv_lengths) >= 10.0).sum()),
        n_bundles=nb,
        local_fraction=local / max(top.n_edges, 1),
    )
