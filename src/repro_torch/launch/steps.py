"""Step builders shared by ``train.py`` and the serving drivers.

The port of ``repro/launch/steps.py``.  ``make_train_step`` builds the
train step over an ``LM`` (the port's counterpart of the reference's
parameter tree): microbatched gradient accumulation in float32, optional
int8 error-feedback gradient compression, and AdamW, updating the model
and the ``OptState`` in place.  ``make_prefill_step`` / ``make_decode_step``
wrap the serving entry points.  A mesh (sharding) waits for the mesh
slice (ROADMAP.md, queue 1, item 4).

The reference's step is functional, and its fault-tolerant loop drops the
new state of a step whose loss is not finite (``nan_policy="skip"``).  An
in-place step would already have overwritten the old one, so the port's
step applies no update when the loss is not finite: one host read of
``isfinite``, where the loop reads the loss anyway.  After such a step the
parameters, ``mu``, ``nu``, ``step`` and the error-feedback memory are
bit for bit what they were.
"""

from __future__ import annotations

import torch

from ..convert import reference_decay, reference_groups
from ..models import decode_step, loss_fn, prefill
from ..optim.adamw import OptState, adamw_update, global_norm
from ..optim.compression import ef_roundtrip

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (sharded train and serve steps) is the mesh and sharding "
            "slice of the port (ROADMAP.md, queue 1, item 4); pass mesh=None")


def _check(model, cfg, dtype) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model's config is {model.cfg.name} "
                         f"(remat={model.cfg.remat!r}), the step's "
                         f"{cfg.name} (remat={cfg.remat!r})")
    if model.dtype != dtype:
        raise ValueError(f"the step runs in {dtype}; the model's weights are "
                         f"{model.dtype} (the port computes in the weights' "
                         "dtype)")


def _grads(model, batch: dict, tensors: list):
    """(loss, the gradient of every tensor: zeros where unused)."""
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


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
    and the global gradient norm (0-d tensors on the device)."""
    _no_mesh(mesh)

    def train_step(model, opt: OptState, batch: dict, ef_err=None):
        _check(model, cfg, dtype)
        params = dict(model.named_parameters())
        names, tensors = list(params), list(params.values())
        if microbatches > 1:
            parts = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in tensors]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                mb_loss, grads = _grads(model, {k: v[i] for k, v in
                                                parts.items()}, tensors)
                torch._foreach_add_(gacc, [g.float() for g in grads])
                loss = loss + mb_loss
            grads = torch._foreach_div(gacc, float(microbatches))
            loss = loss / microbatches
        else:
            loss, grads = _grads(model, batch, tensors)
        grads = dict(zip(names, grads))
        compress = grad_compression and ef_err is not None
        if not bool(torch.isfinite(loss)):
            # dropped by the loop: nothing is updated
            metrics = {"loss": loss, "grad_norm": global_norm(grads)}
            return (model, opt, metrics, ef_err) if compress else (
                model, opt, metrics)
        if compress:
            grads, ef_err = ef_roundtrip(grads, ef_err,
                                         reference_groups(model))
        _, opt, stats = adamw_update(grads, opt, params, lr,
                                     decay=reference_decay(model))
        metrics = {"loss": loss, **stats}
        return (model, opt, metrics, ef_err) if compress else (
            model, opt, metrics)

    return train_step


def make_prefill_step(cfg, mesh=None, dtype=torch.bfloat16):
    _no_mesh(mesh)

    def prefill_step(model, batch):
        _check(model, cfg, dtype)
        return prefill(model, batch)

    return prefill_step


def make_decode_step(cfg, mesh=None, dtype=torch.bfloat16):
    _no_mesh(mesh)

    def serve_step(model, cache, token, pos):
        _check(model, cfg, dtype)
        return decode_step(model, cache, token, pos)

    return serve_step
