"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
        --steps 20 --reduced --device cpu

The port of ``repro/launch/train.py``: config -> model -> train step ->
deterministic data pipeline -> fault-tolerant loop with async checkpoints,
and the fabric model the cross-pod collectives would ride.  ``--reduced``
trains the small config in float32 without activation checkpointing;
otherwise the full config trains in bfloat16 with ``cfg.remat``.  One
device: a mesh (``--production-mesh``) waits for the mesh slice.  Weights
come from ``torch.Generator`` seeded with ``--seed``, not ``jax.random``,
so the two packages train different draws; the batches are the same
(``data.SyntheticLM``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get
from ..data.pipeline import SyntheticLM
from ..device import resolve
from ..fabric import make_fabric
from ..models import init_params
from ..optim.adamw import adamw_init
from ..optim.compression import ef_init
from ..runtime.fault import FaultConfig, ResilientLoop
from .steps import make_train_step

__all__ = ["main", "parser"]


@torch.no_grad()
def _bind(model, params: dict) -> None:
    """Copy ``params`` into the model's weights where they are other
    tensors: after ``ResilientLoop`` restored a checkpoint, its state holds
    the restored copies."""
    for name, p in model.named_parameters():
        if params[name] is not p:
            p.copy_(params[name])


def parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device`` (``cuda`` unless asked)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fabric", choices=["jellyfish", "fattree"],
                    default="jellyfish")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    dev = resolve(args.device)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the mesh is the mesh and sharding slice of "
            "the port (ROADMAP.md, queue 1, item 4)")
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none" if args.reduced else cfg.remat)

    fabric = make_fabric(args.fabric, n_pods=2, device=dev)
    print(f"fabric: {fabric.describe()}")
    print(f"device: {dev}  arch: {cfg.name} "
          f"({cfg.param_count()/1e6:.1f}M params)")

    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = init_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    opt = adamw_init(model)
    compress = args.grad_compression == "int8"
    step_fn = make_train_step(cfg, microbatches=args.microbatches, lr=args.lr,
                              grad_compression=compress, dtype=dtype)

    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch,
                       seed=args.seed)
    ckpt = CheckpointManager(args.checkpoint_dir, keep=2)

    state = {"params": dict(model.named_parameters()), "opt": opt}
    if compress:
        state["ef"] = ef_init(model)

    def run_step(state, batch):
        _bind(model, state["params"])
        if compress:
            _, o, m, e = step_fn(model, state["opt"], batch, state["ef"])
            return {"params": dict(model.named_parameters()), "opt": o,
                    "ef": e}, m
        _, o, m = step_fn(model, state["opt"], batch)
        return {"params": dict(model.named_parameters()), "opt": o}, m

    def batch_at(step):
        b = data.batch_at(step)
        return {"tokens": torch.from_numpy(b["tokens"][:, :-1]).to(dev)}

    loop = ResilientLoop(
        run_step, state, ckpt, batch_at,
        FaultConfig(checkpoint_every=args.checkpoint_every),
    )

    t0 = time.time()
    report = loop.run(args.steps)
    dt = time.time() - t0
    losses = report.losses
    print(
        f"done: {report.steps_done} steps in {dt:.1f}s "
        f"({dt / max(report.steps_done, 1) * 1e3:.1f} ms/step) "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(restores={report.restores}, nan_skips={report.skipped_nan})"
    )
    if len(losses) > 10:
        assert losses[-1] < losses[0], "loss did not improve"
    return report


if __name__ == "__main__":
    main()
