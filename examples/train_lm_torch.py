"""End-to-end training example on the PyTorch port: train a ~100M-param
dense LM for a few hundred steps with the production stack — train step,
deterministic data pipeline, async checkpointing, fault-tolerant loop.

The counterpart of ``examples/train_lm.py`` through ``repro_torch``, on
``--device``, eager PyTorch in float32.  Weights come from
``torch.Generator`` seeded with 0, not ``jax.random``; the batches are the
reference's (``data.SyntheticLM``).

    PYTHONPATH=src python examples/train_lm_torch.py            # ~100M, 200 steps
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu

``main()`` returns the loop's report (steps done, losses).
"""

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault import FaultConfig, ResilientLoop

HUNDRED_M = ArchConfig(
    name="demo-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2560, vocab_size=8192, head_dim=64, rope_theta=10_000.0,
    remat="none",
)

TINY = dataclasses.replace(
    HUNDRED_M, name="demo-tiny", n_layers=2, d_model=128, d_ff=256,
    n_heads=4, n_kv_heads=2, head_dim=32, vocab_size=1024,
)


def train(args, ckpt_dir: str):
    dev = resolve(args.device)
    cfg = TINY if args.tiny else HUNDRED_M
    steps = args.steps or (30 if args.tiny else 200)  # full run: ~200 steps
    seq = args.seq_len or (64 if args.tiny else 256)
    batch = args.batch or (8 if args.tiny else 16)

    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} ({n/1e6:.1f}M params), {steps} steps, "
          f"batch {batch} x seq {seq}, device {dev}")

    step_fn = make_train_step(cfg, mesh=None, microbatches=1, lr=3e-4,
                              dtype=torch.float32)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    ckpt = CheckpointManager(ckpt_dir, keep=2)

    @torch.no_grad()
    def bind(params):
        # after a restore the loop's state holds the restored copies
        for name, p in model.named_parameters():
            if params[name] is not p:
                p.copy_(params[name])

    def run_step(state, b):
        bind(state["params"])
        _, o, m = step_fn(model, state["opt"], b)
        return {"params": dict(model.named_parameters()), "opt": o}, m

    def batch_at(step):
        b = data.batch_at(step)
        return {"tokens": torch.from_numpy(b["tokens"][:, :-1]).to(dev)}

    loop = ResilientLoop(
        run_step, {"params": dict(model.named_parameters()),
                   "opt": adamw_init(model)}, ckpt, batch_at,
        FaultConfig(checkpoint_every=max(steps // 4, 10)),
    )
    t0 = time.time()
    rep = loop.run(steps)
    ckpt.wait()
    dt = time.time() - t0
    print(f"{rep.steps_done} steps in {dt:.1f}s "
          f"({dt/max(rep.steps_done,1)*1e3:.0f} ms/step)")
    print(f"loss: {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}")
    if rep.losses[-1] >= rep.losses[0]:
        raise RuntimeError("training must reduce loss")
    print("OK")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the loop checkpoints (default: a temporary "
                    "directory, removed at the end)")
    args = ap.parse_args(argv)
    if args.checkpoint_dir is not None:
        return train(args, args.checkpoint_dir)
    with tempfile.TemporaryDirectory() as tmp:
        return train(args, tmp)


if __name__ == "__main__":
    main()
