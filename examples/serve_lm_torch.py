"""Batched serving example on the PyTorch port: prefill + greedy decode
with the ring-buffer KV cache, across three architecture families (full
attention / SWA-MoE / SSM).

The counterpart of ``examples/serve_lm.py`` through ``repro_torch``: each
arch at its ``reduced()`` config in float32 on ``--device``, eager PyTorch
(``launch.serve.generate``).  Weights and prompts come from
``torch.Generator`` seeded with 0, not ``jax.random``, so the two packages
serve different draws.

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

``main()`` returns each arch's readings (family, timings, tokens).
"""

import argparse

import torch

from repro_torch.configs import get
from repro_torch.device import resolve
from repro_torch.launch.serve import generate
from repro_torch.models import init_params

ARCHS = ("qwen2.5-32b", "mixtral-8x22b", "rwkv6-1.6b", "recurrentgemma-2b")


def serve(arch: str, dev, batch=4, prompt_len=32, max_new=12) -> dict:
    cfg = get(arch).reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int64)
    out = generate(model, prompts, max_new)
    toks = out.tokens
    assert bool(torch.all((toks >= 0) & (toks < cfg.vocab_size)))
    print(f"{arch:22s} [{cfg.family:12s}] prefill {out.prefill_ms:7.1f} ms | "
          f"decode {out.decode_ms_per_token:6.1f} ms/tok | sample "
          f"{toks[0, :6].tolist()}")
    return {"family": cfg.family, "prefill_ms": out.prefill_ms,
            "decode_ms_per_token": out.decode_ms_per_token,
            "tokens": toks.cpu()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve(ap.parse_args(argv).device)
    print(f"{'arch':22s} {'family':14s}")
    return {arch: serve(arch, dev) for arch in ARCHS}


if __name__ == "__main__":
    main()
