"""The port's bfloat16 serving path against the reference's, on the CPU.

``serve`` runs its full-width models in bfloat16.  Here both sides serve the
same bfloat16 weights (the reference's float32 ``init_params`` output, each
side rounding it to bfloat16: the same values) on the same numpy-drawn
tokens, one architecture per family at ``reduced()``: a 24-token prefill
(the hybrid's 16-slot window wraps) and 6 decode steps fed given tokens.
Bounds, on the largest difference over the largest |logit| of the
reference side, at every step:

- the port's bf16 against the reference's bf16: 0.08 (the two sum in
  different orders and round each intermediate to bf16, 2^-8 relative; the
  readings are 0.007-0.063, the reference's own bf16 against its f32
  0.010-0.041);
- the port's bf16 against the reference's f32: no more than twice the
  reference's own bf16-against-f32 gap over the same steps (read: at most
  1.4 times).

Run as a script, the file reads bf16 against f32 at full width on the
CPU, the depth cut to ``--layers`` (the first j layers of one draw, for
j = 1 .. layers), for the reference and the port on the same weights, with
the RWKV bonus ``faaaa`` at its init (0) and, with ``--bonus s``, drawn
from N(0, s^2); one line of JSON per depth, each gap a list over the
prefill's last position and then ``--steps`` decode positions:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bf16.py \\
        --arch rwkv6-1.6b --layers 3 --bonus 0.5 --prompt 32 --steps 2
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import decode_step as ref_decode
from repro.models import init_params as ref_init
from repro.models import prefill as ref_prefill
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import decode_step, prefill

FAMILY_ARCHS = ["rwkv6-1.6b", "minitron-8b", "qwen2-moe-a2.7b",
                "recurrentgemma-2b"]
KEY = jax.random.PRNGKey(0)
PROMPT, STEPS = 24, 6
BF16_REL = 0.08


def rel(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    g = np.asarray(got, dtype=np.float32)
    w = np.asarray(want, dtype=np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


def logit_runs(rcfg, cfg, params, toks, prompt: int, steps: int) -> dict:
    """Prefill ``toks[:, :prompt]`` and decode ``toks[:, prompt:]`` (given
    tokens) on four sides: the reference and the port, each in float32 and
    in bfloat16 from the same float32 ``params``.  Returns each side's
    float32 logits, one array per step."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    refs = {jnp.float32: params,
            jnp.bfloat16: jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16), params)}
    out = {}
    max_len = prompt + steps
    for name, dt in (("ref32", jnp.float32), ("ref16", jnp.bfloat16)):
        pf = jax.jit(lambda p, t, dt=dt: ref_prefill(
            p, {"tokens": t}, rcfg, max_len=max_len, dtype=dt))
        dec = jax.jit(lambda p, c, t, pos, dt=dt: ref_decode(
            p, c, t, pos, rcfg, dtype=dt))
        lg, cache = pf(refs[dt], jnp.asarray(toks[:, :prompt]))
        out[name] = [_as_f32(lg)]
        for i in range(steps):
            lg, cache = dec(refs[dt], cache, jnp.asarray(toks[:, prompt + i]),
                            jnp.int32(prompt + i))
            out[name].append(_as_f32(lg))
        del cache
    for name, dt in (("port32", torch.float32), ("port16", torch.bfloat16)):
        model = lm_params_from_numpy(cfg, tree, dtype=dt, device="cpu")
        lg, cache = prefill(model, {"tokens": torch.tensor(toks[:, :prompt])},
                            max_len=max_len)
        out[name] = [_as_f32(lg)]
        for i in range(steps):
            lg, cache = decode_step(model, cache,
                                    torch.tensor(toks[:, prompt + i]),
                                    prompt + i)
            out[name].append(_as_f32(lg))
        del model, cache
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_prefill_and_decode_match_reference_bf16(arch):
    rcfg = ref_configs.get(arch).reduced()
    cfg = configs.get(arch).reduced()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS)).astype(np.int32)
    runs = logit_runs(rcfg, cfg, ref_init(rcfg, KEY, jnp.float32), toks,
                      PROMPT, STEPS)
    ref_gap = [rel(a, b) for a, b in zip(runs["ref16"], runs["ref32"])]
    for step, (got, want) in enumerate(zip(runs["port16"], runs["ref16"])):
        assert np.all(np.isfinite(got)), step
        assert rel(got, want) <= BF16_REL, (step, rel(got, want))
    port_gap = [rel(a, b) for a, b in zip(runs["port16"], runs["ref32"])]
    assert max(port_gap) <= 2 * max(ref_gap), (port_gap, ref_gap)
    assert max(ref_gap) > 1e-3  # the bf16 sides really ran in bf16


def depth_reading(arch: str, layers: int, bonus: float, batch: int = 2,
                  prompt: int = 32, steps: int = 2) -> list:
    """bf16 against f32 at full width, the first j layers of one draw for
    j = 1 .. ``layers``: each side's gap per step (prefill, then decode)."""
    rcfg = dataclasses.replace(ref_configs.get(arch), n_layers=layers)
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    params = ref_init(rcfg, KEY, jnp.float32)
    if bonus and "faaaa" in params.get("layers", {}):
        u = np.random.default_rng(3).standard_normal(
            params["layers"]["faaaa"].shape) * bonus
        params["layers"]["faaaa"] = jnp.asarray(u, jnp.float32)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, prompt + steps)).astype(np.int32)
    rows = []
    for j in range(1, layers + 1):
        sub = dict(params, layers=jax.tree_util.tree_map(
            lambda a, j=j: a[:j], params["layers"]))
        runs = logit_runs(dataclasses.replace(rcfg, n_layers=j),
                          dataclasses.replace(cfg, n_layers=j), sub, toks,
                          prompt, steps)
        rows.append({
            "arch": arch, "layers": j, "bonus_std": bonus,
            "ref_bf16_vs_f32": [rel(a, b) for a, b in
                                zip(runs["ref16"], runs["ref32"])],
            "port_bf16_vs_f32": [rel(a, b) for a, b in
                                 zip(runs["port16"], runs["port32"])],
            "port_vs_ref_bf16": [rel(a, b) for a, b in
                                 zip(runs["port16"], runs["ref16"])],
            "port_vs_ref_f32": [rel(a, b) for a, b in
                                zip(runs["port32"], runs["ref32"])],
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--bonus", type=float, default=0.0)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    for bonus in sorted({0.0, args.bonus}):
        depth_reading(args.arch, args.layers, bonus, prompt=args.prompt,
                      steps=args.steps)
