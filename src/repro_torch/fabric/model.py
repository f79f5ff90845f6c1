"""FabricModel: the physical cluster interconnect as a first-class object.

The port of ``repro/fabric/model.py``.  A FabricModel holds the cluster's
inter-pod network (``jellyfish`` by default, ``fattree`` as the structured
baseline), embeds a ring over its pods, and exports effective bandwidths
for collective cost models (``fabric.collectives``).

Elastic scaling and fault tolerance ride the paper's machinery directly:
``expand(n)`` is incremental Jellyfish expansion (§4.2); ``fail(frac)`` /
``remove(pod)`` is §4.3 — the degraded fabric is just a smaller random
graph, so the runtime re-embeds and continues instead of halting.

Every model carries the ``device`` its APSP, admission prunes and path
systems run on (default ``"cuda"``; a machine without CUDA raises unless
the caller asks for the CPU); mutations carry it to the child.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import expansion, failures
from ..core.fattree import fattree
from ..core.jellyfish import jellyfish
from ..core.metrics import path_stats
from ..core.routing import PathSystem, build_path_system, update_path_system
from ..core.topology import Topology
from ..core.traffic import Commodities
from ..device import resolve
from .collectives import LinkSpec
from .embedding import RingEmbedding, all_to_all_congestion, embed_ring

__all__ = ["FabricModel", "make_fabric"]


@dataclasses.dataclass
class FabricModel:
    """Physical inter-pod fabric + link model + cached ring embedding.

    Mutation methods (``expand``/``fail``/``remove``) thread the predecessor
    topology and its cached path system into the new model, so the first
    ``path_system`` call after a mutation goes through the delta-routing
    engine (``core.routing.update_path_system``) instead of a full rebuild —
    one build at launch, cheap deltas for every elastic event after.
    """

    topology: Topology
    link: LinkSpec
    name: str = "fabric"
    device: "str | torch.device" = "cuda"
    _ring: RingEmbedding | None = None
    _ps: PathSystem | None = None  # cached path system (last comm routed)
    _parent: "tuple[Topology, PathSystem] | None" = None  # delta pedigree

    def __post_init__(self) -> None:
        self.device = resolve(self.device)

    # ------------------------------------------------------------------ #
    def ring(self, members: np.ndarray | None = None, refresh: bool = False) -> RingEmbedding:
        if self._ring is None or refresh or members is not None:
            emb = embed_ring(self.topology, members, device=self.device)
            if members is None:
                self._ring = emb
            return emb
        return self._ring

    def ring_link(self, members: np.ndarray | None = None) -> LinkSpec:
        """LinkSpec with efficiency scaled by the ring embedding congestion."""
        emb = self.ring(members)
        return LinkSpec(self.link.bandwidth, self.link.latency, emb.efficiency)

    def a2a_efficiency(self, members: np.ndarray | None = None) -> float:
        c = all_to_all_congestion(self.topology, members, device=self.device)
        return 1.0 / max(c, 1.0)

    def describe(self) -> str:
        st = path_stats(self.topology)
        emb = self.ring()
        return (
            f"{self.name}: {self.topology.describe()} | paths {st} | {emb.summary()}"
        )

    # ------------------------- routing state -------------------------- #
    def path_system(self, comm: Commodities, k: int = 8) -> PathSystem:
        """Route ``comm`` over the fabric, incrementally when possible.

        After an ``expand``/``fail``/``remove``, the predecessor's cached
        path system is spliced forward through the recorded topology delta;
        only commodities the delta actually touched are re-enumerated.  The
        result is cached so the next mutation can chain from it.
        """
        if self._parent is not None:
            top_old, ps_old = self._parent
            ps = update_path_system(ps_old, top_old, self.topology, comm, k=k,
                                    device=self.device)
        else:
            ps = build_path_system(self.topology, comm, k=k,
                                   device=self.device)
        self._ps = ps
        self._parent = None  # chained: future mutations splice from ps
        return ps

    def _child(self, top: Topology) -> "FabricModel":
        parent = (self.topology, self._ps) if self._ps is not None else None
        return FabricModel(top, self.link, self.name, device=self.device,
                           _parent=parent)

    # ----------------------- elasticity / faults ---------------------- #
    def expand(self, n_new: int, seed: int = 0) -> "FabricModel":
        """Add pods via the paper's incremental expansion; re-embeds rings."""
        top = self.topology
        top = expansion.expand_to(top, top.n_switches + n_new, seed=seed)
        return self._child(top)

    def fail(self, link_fraction: float, seed: int = 0) -> "FabricModel":
        return self._child(failures.fail_links(self.topology, link_fraction, seed))

    def remove(self, pod: int, seed: int = 0) -> "FabricModel":
        return self._child(expansion.remove_switch(self.topology, pod, seed))


def make_fabric(
    kind: str = "jellyfish",
    n_pods: int = 2,
    degree: int = 4,
    link_gbps: float = 50.0,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> FabricModel:
    """Fabric factory (``kind`` = ``jellyfish`` or ``fattree``).

    For tiny pod counts (a 2-pod run) the "random graph" degenerates
    to parallel links / a clique — that is fine; the machinery matters at
    100s-1000s of pods, which ``chip_smoke.py``'s ``fabric`` phase drives.
    """
    dev = resolve(device)
    link = LinkSpec(bandwidth=link_gbps * 1e9)
    if kind == "jellyfish":
        r = min(degree, max(n_pods - 1, 1))
        top = jellyfish(n_pods, r + 1, r, seed=seed) if n_pods > 2 else _pair(n_pods)
        return FabricModel(top, link, f"jellyfish-fabric({n_pods} pods)",
                           device=dev)
    if kind == "fattree":
        # smallest fat-tree with >= n_pods edge switches; pods sit on edge switches
        k = 4
        while (k * k) // 2 < n_pods:
            k += 2
        top = fattree(k)
        return FabricModel(top, link, f"fattree-fabric(k={k})", device=dev)
    raise ValueError(kind)


def _pair(n: int) -> Topology:
    """Degenerate 1-2 pod fabric."""
    edges = [(0, 1)] if n == 2 else []
    return Topology.regular(n, 2, 1, edges, name=f"pair({n})", kind="pair")
