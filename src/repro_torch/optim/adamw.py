"""AdamW with global-norm clipping over a model's parameters.

The port of ``repro/optim/adamw.py``.  Parameters, gradients and the state
are mappings from the model's parameter names to tensors (an ``nn.Module``
is read through ``named_parameters``).  ``OptState`` holds ``step`` as a
0-d int32 tensor on the parameters' device and ``mu`` / ``nu`` in float32
under the same names.  The update runs under ``torch.no_grad()`` with the
multi-tensor ``torch._foreach_*`` operations, in the reference's order of
operations per element (each product and sum rounded on its own, as the
reference writes them).

The port updates the parameters and the moments in place, where the
reference returns new trees.  ``adamw_update`` checks the gradients' shapes
and makes its two float32 temporaries (one tensor like each parameter,
twice) before it writes anything, so an error leaves the parameters and the
state as they were; at its peak it holds the parameters, the gradients, the
moments and those two temporaries (24 bytes a bf16 parameter).

Weight decay falls on a leaf of rank 2 or more (``decay`` names them; by
default a tensor's own rank decides).  The reference decides by the rank of
its own leaves, whose per-layer weights are stacked with a leading layer
dim, so its per-layer norm weights and biases ((L, d)) are decayed and only
the unstacked 1-D leaves (``final_norm``) are not.  The port's per-layer
tensors are 1-D; the train step passes ``convert.reference_decay(model)``,
which keeps that rule.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

__all__ = ["OptState", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor
    mu: dict
    nu: dict


def named(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or of a mapping."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> OptState:
    params = named(params)
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={n: zeros(p) for n, p in params.items()},
        nu={n: zeros(p) for n, p in params.items()},
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    ts = list(tensors.values()) if isinstance(tensors, Mapping) else list(tensors)
    norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(
    grads,
    state: OptState,
    params,
    lr: "torch.Tensor | float",
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
    decay: Mapping | None = None,
):
    """One AdamW step on ``params`` (updated in place) from ``grads`` (a
    missing or None gradient counts as zeros).  ``decay`` maps a name to
    whether its leaf is decayed.  Returns (params, state, stats)."""
    params = named(params)
    names = list(params)
    ps = [params[n] for n in names]
    gs = []
    for n, p in zip(names, ps):
        g = grads.get(n)
        if g is not None and g.shape != p.shape:
            raise ValueError(f"gradient of {n}: shape {tuple(g.shape)}, the "
                             f"parameter's {tuple(p.shape)}")
        gs.append(torch.zeros_like(p) if g is None else g)
    gnorm = global_norm(gs)
    # every temporary exists before the first write below
    g32 = [g.to(torch.float32, copy=True) for g in gs]
    tmp = [torch.empty_like(g) for g in g32]
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        torch._foreach_mul_(g32, scale)
    step = state.step + 1
    b1c = 1.0 - torch.pow(b1, step.float())
    b2c = 1.0 - torch.pow(b2, step.float())
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    hit = [i for i, (n, p) in enumerate(zip(names, ps))
           if (decay[n] if decay is not None else p.dim() >= 2)]

    # v = b2 v + (1 - b2) g g
    torch._foreach_copy_(tmp, g32)
    torch._foreach_mul_(tmp, 1 - b2)
    torch._foreach_mul_(tmp, g32)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, tmp)
    # m = b1 m + (1 - b1) g
    torch._foreach_mul_(g32, 1 - b1)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g32)
    # u = mhat / (sqrt(vhat) + eps), in g32's storage
    upd = g32
    torch._foreach_copy_(upd, mu)
    torch._foreach_div_(upd, b1c)
    torch._foreach_copy_(tmp, nu)
    torch._foreach_div_(tmp, b2c)
    torch._foreach_sqrt_(tmp)
    torch._foreach_add_(tmp, eps)
    torch._foreach_div_(upd, tmp)
    # u + wd p on the decayed leaves (p in float32)
    if weight_decay and hit:
        wdp = [tmp[i] for i in hit]
        torch._foreach_copy_(wdp, [ps[i] for i in hit])
        torch._foreach_mul_(wdp, weight_decay)
        torch._foreach_add_([upd[i] for i in hit], wdp)
    # p - lr u, in float32, then cast to the parameter's dtype
    torch._foreach_mul_(upd, lr)
    torch._foreach_copy_(tmp, ps)
    torch._foreach_sub_(tmp, upd)
    torch._foreach_copy_(ps, tmp)
    state.step = step
    return params, state, {"grad_norm": gnorm}
