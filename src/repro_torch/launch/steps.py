"""Step functions shared by ``train.py``, ``dryrun.py`` and serving.

The port of ``repro/launch/steps.py``.  ``make_train_step`` builds the
train step over an ``LM`` (the port's counterpart of the reference's
parameter tree): microbatched gradient accumulation in float32, optional
int8 error-feedback gradient compression, and AdamW, updating the model
and the ``OptState`` in place.  ``make_prefill_step`` / ``make_decode_step``
wrap the serving entry points.  All of them take ``mesh=`` and thread the
mesh's ``Sharder`` through the model.

Under a mesh a step places what it is given before it runs, as the
reference's ``jit`` does by its ``in_shardings``: the model's parameters
(replaced in place by DTensor parameters), the ``OptState`` and the
error-feedback memory by ``state_shardings``, the batch by
``batch_shardings`` (each microbatch on its own: the reference's
microbatch i is rows ``i * B/m .. (i+1) * B/m - 1`` of the global batch)
and the decode caches by ``cache_shardings``.  A batch is given as its full
value, the same on every rank; each rank keeps its rows.  Plain tensors
the model makes (positions, masks, zero states) are replicated values
(``implicit_replication``).  The gradients are brought to their
parameters' placements (the data-parallel reduction), the int8 error
feedback compresses each reference leaf's global values, so its blocks and
scales are the unsharded step's (gathered one block-aligned run of a
leaf's tensors at a time), and the metrics come back as full values.

The reference's step is functional, and its fault-tolerant loop drops the
new state of a step whose loss is not finite (``nan_policy="skip"``).  An
in-place step would already have overwritten the old one, so the port's
step applies no update when the loss is not finite: one host read of
``isfinite``, where the loop reads the loss anyway.  After such a step the
parameters, ``mu``, ``nu``, ``step`` and the error-feedback memory are
bit for bit what they were.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..convert import reference_decay, reference_groups
from ..models import decode_step, loss_fn, prefill
from ..optim.adamw import OptState, adamw_update, global_norm
from ..optim.compression import BLOCK, ef_roundtrip
from ..runtime.sharding import (
    Sharder,
    Sharding,
    batch_axes,
    cache_shardings,
    param_shardings,
)

__all__ = [
    "batch_shardings",
    "cache_shardings",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "place_model",
    "place_state",
    "state_shardings",
]


def _sharder(cfg, mesh):
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (launch.mesh), not "
                        f"{type(mesh).__name__}")
    return Sharder(mesh, dp_only=(cfg.family == "rwkv6"))


def _check(model, cfg, dtype) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model's config is {model.cfg.name} "
                         f"(remat={model.cfg.remat!r}), the step's "
                         f"{cfg.name} (remat={cfg.remat!r})")
    if model.dtype != dtype:
        raise ValueError(f"the step runs in {dtype}; the model's weights are "
                         f"{model.dtype} (the port computes in the weights' "
                         "dtype)")


def _replicating(shd):
    return implicit_replication() if shd is not None else (
        contextlib.nullcontext())


def _finite(loss: torch.Tensor) -> bool:
    """Whether the step updates: the loss is finite.  A fake tensor (the
    dry run's trace) has no value to read, and its step traces the
    update."""
    return is_fake(loss) or bool(torch.isfinite(loss))


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


# --------------------------------------------------------------------------- #
# sharding specs and placement
# --------------------------------------------------------------------------- #


def batch_shardings(batch, mesh, batch_size: int, all_axes: bool = False):
    """The batch's rows over ``batch_axes``: a ``Sharding`` for a tensor, a
    dict of them for a dict of tensors."""
    ba = batch_axes(mesh, batch_size, all_axes)

    def one(t):
        return Sharding(mesh, (ba,) + (None,) * (t.dim() - 1))

    if isinstance(batch, torch.Tensor):
        return one(batch)
    return {k: one(v) for k, v in batch.items()}


def state_shardings(model, mesh):
    """(parameter shardings, ``OptState`` of shardings): the optimizer
    mirrors the parameters; its step is replicated."""
    ps = param_shardings(model, mesh)
    return ps, OptState(step=Sharding(mesh, ()), mu=ps, nu=ps)


@torch.no_grad()
def place_model(model: nn.Module, shardings: dict) -> None:
    """Replace each parameter that is not yet placed by its sharding with a
    DTensor parameter holding its shard (in place, idempotent)."""
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        if isinstance(p, DTensor) and tuple(p.placements) == sh.placements:
            continue
        setattr(mod, leaf, nn.Parameter(sh.distribute(p.detach()),
                                        requires_grad=p.requires_grad))


def _placed(tensors: dict, shardings: dict) -> dict:
    return {n: t if isinstance(t, DTensor) and tuple(t.placements)
            == shardings[n].placements else shardings[n].distribute(t)
            for n, t in tensors.items()}


@torch.no_grad()
def place_state(model, opt: OptState, mesh) -> dict:
    """Place the model's parameters and ``opt`` by ``state_shardings`` (in
    place, idempotent); returns the parameter shardings."""
    ps, os_ = state_shardings(model, mesh)
    place_model(model, ps)
    opt.mu = _placed(opt.mu, ps)
    opt.nu = _placed(opt.nu, ps)
    opt.step = _placed({"step": opt.step}, {"step": os_.step})["step"]
    return ps


def _place_batch(batch: dict, mesh, cfg) -> dict:
    size = next(iter(batch.values())).shape[0]
    sh = batch_shardings(batch, mesh, size, all_axes=cfg.family == "rwkv6")
    return {k: sh[k].distribute(_full(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------------- #


def _grads(model, batch: dict, tensors: list, shd):
    """(loss, the gradient of every tensor: zeros where unused; under a mesh
    each in its tensor's placements)."""
    loss, _ = loss_fn(model, batch, shd)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                materialize_grads=True)
    if shd is not None:
        grads = [g.redistribute(t.device_mesh, t.placements)
                 for g, t in zip(grads, tensors)]
    return _full(loss.detach()), list(grads)


def _ef_global(grads: dict, err: dict, groups, shardings: dict):
    """``ef_roundtrip`` on the global values of the gradients and the
    memory, its results placed back by ``shardings``.  A reference leaf's
    int8 blocks run across its group's tensors in order, so the group is
    gathered a run of tensors at a time, each run ending where a block
    does (its flat length a multiple of ``BLOCK``): a rank holds the full
    values of one parameter (or of the few whose sizes do not divide
    ``BLOCK``), not of the whole model, and frees them before the next."""
    out, new = {}, {}
    for names in groups:
        run, size = [], 0
        for i, n in enumerate(names):
            run.append(n)
            size += grads[n].numel()
            if size % BLOCK and i + 1 < len(names):
                continue
            deq, mem = ef_roundtrip({m: _full(grads[m]) for m in run},
                                    {m: _full(err[m]) for m in run}, [run])
            for m in run:
                out[m] = shardings[m].distribute(deq.pop(m))
                new[m] = shardings[m].distribute(mem.pop(m))
            run, size = [], 0
    return out, new


def make_train_step(
    cfg,
    mesh=None,
    microbatches: int = 1,
    lr: float = 3e-4,
    grad_compression: bool = False,
    dtype=torch.bfloat16,
):
    """``train_step(model, opt, batch, ef_err=None) -> (model, opt,
    metrics[, ef_err])`` for an ``LM`` of ``cfg`` whose weights are
    ``dtype``; ``batch`` is split into ``microbatches`` equal parts along
    its first dim.  With ``grad_compression`` and an error memory
    (``optim.ef_init``) the gradients make the int8 round trip before
    AdamW and the new memory is returned too.  ``metrics`` holds the loss
    and the global gradient norm (0-d tensors on the device).  With
    ``mesh`` the step places the model, ``opt``, ``ef_err`` and each
    microbatch first (see the module docstring)."""
    shd = _sharder(cfg, mesh)

    def train_step(model, opt: OptState, batch: dict, ef_err=None):
        _check(model, cfg, dtype)
        ps = place_state(model, opt, mesh) if shd is not None else None
        params = dict(model.named_parameters())
        names, tensors = list(params), list(params.values())
        if microbatches > 1:
            parts = [{k: _full(v).reshape(
                          (microbatches, v.shape[0] // microbatches)
                          + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(microbatches)]
        else:
            parts = [batch]
        if shd is not None:
            parts = [_place_batch(part, mesh, cfg) for part in parts]
        with _replicating(shd):
            if microbatches > 1:
                gacc = [torch.zeros_like(p, dtype=torch.float32)
                        for p in tensors]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for part in parts:
                    mb_loss, grads = _grads(model, part, tensors, shd)
                    torch._foreach_add_(gacc, [g.float() for g in grads])
                    loss = loss + mb_loss
                grads = torch._foreach_div(gacc, float(microbatches))
                loss = loss / microbatches
            else:
                loss, grads = _grads(model, parts[0], tensors, shd)
            grads = dict(zip(names, grads))
            compress = grad_compression and ef_err is not None
            if not _finite(loss):
                # dropped by the loop: nothing is updated
                metrics = {"loss": loss,
                           "grad_norm": _full(global_norm(grads))}
                return (model, opt, metrics, ef_err) if compress else (
                    model, opt, metrics)
            if compress and shd is not None:
                grads, ef_err = _ef_global(grads, ef_err,
                                           reference_groups(model), ps)
            elif compress:
                grads, ef_err = ef_roundtrip(grads, ef_err,
                                             reference_groups(model))
            _, opt, stats = adamw_update(grads, opt, params, lr,
                                         decay=reference_decay(model))
        metrics = {"loss": loss, **{k: _full(v) for k, v in stats.items()}}
        return (model, opt, metrics, ef_err) if compress else (
            model, opt, metrics)

    return train_step


def make_prefill_step(cfg, mesh=None, dtype=torch.bfloat16):
    """``prefill_step(model, batch) -> (last logits, caches)``; with
    ``mesh`` the parameters and the batch are placed first and the caches
    come back placed by ``cache_shardings``."""
    shd = _sharder(cfg, mesh)

    def prefill_step(model, batch):
        _check(model, cfg, dtype)
        if shd is None:
            return prefill(model, batch)
        place_model(model, param_shardings(model, mesh))
        with _replicating(shd):
            return prefill(model, _place_batch(batch, mesh, cfg), shd=shd)

    return prefill_step


def make_decode_step(cfg, mesh=None, dtype=torch.bfloat16):
    """``serve_step(model, cache, token, pos) -> (logits, cache)``; with
    ``mesh`` the parameters, the caches (``cache_shardings``; the returned
    caches are the placed ones) and the tokens are placed first."""
    shd = _sharder(cfg, mesh)

    def serve_step(model, cache, token, pos):
        _check(model, cfg, dtype)
        if shd is None:
            return decode_step(model, cache, token, pos)
        place_model(model, param_shardings(model, mesh))
        b = token.shape[0]
        cache = [_placed(c, sh) for c, sh in zip(
            cache, cache_shardings(cache, mesh, b))]
        token = batch_shardings(token, mesh, b).distribute(_full(token))
        with _replicating(shd):
            return decode_step(model, cache, token, pos, shd=shd)

    return serve_step
