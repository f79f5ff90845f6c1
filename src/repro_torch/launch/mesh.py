"""Device meshes over the ranks of ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  A mesh is a ``DeviceMesh`` over the
ranks of the default process group, with the reference's axis names:
``("data", "model")`` in one pod, ``("pod", "data", "model")`` across
pods.  It is built on the card (NCCL) unless the caller asks for the CPU
(gloo), or over whatever group exists (the dry run's fake group).  With no
process group these functions make a one-rank group themselves, on an
in-memory store, so no address or port is needed.  A world too small for
the asked shape raises and names the world it needs, as the reference's
``jax.make_mesh`` fails there: nothing shrinks the mesh or changes the
backend quietly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve

__all__ = ["make_fabric_aware_mesh", "make_local_mesh", "make_production_mesh",
           "world_size"]


def world_size(device="cuda") -> int:
    """The default group's world size; with no group, a one-rank group is
    made on ``device``'s backend (NCCL for the card, gloo for the CPU)."""
    dev = resolve(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(device, ranks: np.ndarray, names: tuple) -> DeviceMesh:
    need = ranks.size
    have = world_size(device)
    if have < need:
        raise ValueError(f"a {'x'.join(map(str, ranks.shape))} mesh "
                         f"{names} needs a world of {need} ranks; the process "
                         f"group has {have}")
    return DeviceMesh(resolve(device).type, torch.as_tensor(ranks),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """16x16 = 256 ranks a pod ('data', 'model'); 2 pods = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, np.arange(math.prod(shape)).reshape(shape), names)


def make_local_mesh(model_parallel: int | None = None,
                    device="cuda") -> DeviceMesh:
    """('data', 'model') over the whole world; the model axis is
    ``model_parallel`` halved until it divides the world."""
    n = world_size(device)
    mp = model_parallel or 1
    while n % mp:
        mp //= 2
    return _mesh(device, np.arange(n).reshape(n // mp, mp), ("data", "model"))


def make_fabric_aware_mesh(fabric, pods: int, per_pod_shape=(16, 16),
                           device="cuda"):
    """Multi-pod mesh whose pod axis follows the fabric's ring embedding.

    Cross-pod ring collectives step between mesh-adjacent pods; ordering
    the pod axis by the Jellyfish ring embedding makes those steps land on
    the planned low-congestion routes.  Pod p holds the ranks
    ``p * per_pod .. (p + 1) * per_pod - 1``; the mesh stacks the pods'
    blocks in ring order.  Returns (mesh, pod_order)."""
    emb = fabric.ring(members=np.arange(pods))
    order = [int(p) for p in emb.order]
    per_pod = math.prod(per_pod_shape)
    blocks = [np.arange(p * per_pod, (p + 1) * per_pod) for p in order]
    ranks = np.stack(blocks).reshape((pods,) + tuple(per_pod_shape))
    return _mesh(device, ranks, ("pod", "data", "model")), order
