"""Batched serving: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --device cpu

The port of ``repro/launch/serve.py``: one prefill, then one
``decode_step`` per token against the ring-buffer KV caches / recurrent
states, in float32 with ``--reduced`` and bfloat16 otherwise.  Padded vocab
ids are masked before the argmax.  Weights come from ``torch.Generator``
(seeded with ``--seed``) on the device, and prompts from a CPU
``torch.Generator`` with the same seed: the reference draws both from
``jax.random``, so the two packages serve different weights and prompts.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get
from ..device import resolve
from ..models import decode_step, init_params, prefill

__all__ = ["Generated", "generate", "main"]


@dataclasses.dataclass
class Generated:
    """Greedy tokens (B, max_new) and the synchronized wall times."""

    tokens: torch.Tensor
    prefill_ms: float
    decode_ms_per_token: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    logits = logits.clone()
    logits[:, vocab_size:] = -float("inf")  # mask padded vocab
    return torch.argmax(logits, dim=-1)


@torch.inference_mode()
def generate(model, prompts: torch.Tensor, max_new: int) -> Generated:
    """Prefill ``prompts`` (B, S) and decode ``max_new`` tokens greedily
    (the first from the prefill's logits), under ``torch.inference_mode()``:
    the weights are trainable, and serving records no graph on them."""
    cfg, dev = model.cfg, model.device
    prompts = prompts.to(dev)
    s = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": prompts}, max_len=s + max_new)
    tok = _greedy(logits, cfg.vocab_size)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        logits, cache = decode_step(model, cache, tok, s + i)
        tok = _greedy(logits, cfg.vocab_size)
        generated.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    return Generated(torch.stack(generated, dim=1), t_prefill * 1e3,
                     dt / max(max_new - 1, 1) * 1e3)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = init_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int64)

    out = generate(model, prompts, args.max_new)
    toks = out.tokens
    assert bool(torch.all((toks >= 0) & (toks < cfg.vocab_size)))
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}")
    print(f"prefill: {out.prefill_ms:.1f} ms; decode: "
          f"{out.decode_ms_per_token:.1f} ms/token")
    print("sample token ids:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
