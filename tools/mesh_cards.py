#!/usr/bin/env python3
"""The sharded model steps across every card of one host, against one card.

    python3 tools/mesh_cards.py            # every card, NCCL
    python3 tools/mesh_cards.py --cpu 4    # four gloo ranks on the CPU

One process per card (``torch.multiprocessing`` spawn, NCCL over a
``FileStore`` in a temporary directory), meshes of ``make_local_mesh`` over
them: (world, 1), (2, world / 2) and (1, world).  On each mesh, one reduced
arch per family (dense, MoE, RWKV-6, RG-LRU hybrid) in float32 with TF32
off: the sharded loss, every gradient and one AdamW step (lr 1e-3) against
the unsharded step on the same card from the same weights and batch, and
a sharded prefill and three decode steps against ``mesh=None`` (logits
within the serve phase's bounds).  Bounds of the train step:

- the loss within rtol 1e-6;
- each gradient within ``GRAD_REL`` of its leaf's largest magnitude: 2e-5,
  2e-4 for RWKV-6 (the train phase's card-against-CPU gate,
  ``chip_smoke.train_rel``).  A sharded gradient sums its partial
  products in another order than the unsharded one, and that order alone
  moves it.  Each arch also reads both against float64 gradients from the
  same weights (``unsharded_f64_rel``, ``sharded_f64_rel``): each float32
  order's own distance from the exact gradient, of which their gap is the
  difference; and ``--cpu`` runs the same layouts on gloo ranks against the
  CPU's unsharded step (PERF.md).  The
  bound must have teeth: each arch also reads its gradients with the
  sharded backward's pending (``Partial``) reductions dropped, each rank
  keeping its own partial sum (at ``Sharder.act``'s gradient and at each
  parameter's), and that planted fault must land above the bound wherever
  the layout has such a reduction;
- the int8 error feedback's round trip (``launch.steps._ef_global``) of
  the unsharded gradients placed on the mesh equals the unsharded round
  trip bit for bit;
- the parameters' largest gap is reported, not bounded: Adam's first step
  moves a weight by about lr whatever its gradient's size, so where a
  gradient is near zero a last-bit gap can move it by up to 2 lr.

Then, on the cards only, ``internvl2-1b`` at full width in bf16 (batch
8 x 128, ``launch.train``'s defaults) on each mesh: two sharded steps and
two unsharded ones, each loss against an unsharded float32 twin's (the
same weights, the same two steps).  The sharded bf16 losses are held to
the gate the ``train`` phase holds unsharded bf16 to against its float32
twin (``chip_smoke.TRAIN_BF16_LOSS_REL``, 0.005): sharded bf16 may lie no
farther from float32 than bf16 is allowed to.  Their gap from the
unsharded bf16 losses is reported, not bounded: two bf16 runs whose
gradients differ in the last bits round their updates apart, and may
land on either side of the float32 loss.  The sharded step's time (best
of 3, host clock to a synchronize on every rank).  Needs
at least two cards (or ``--cpu`` ranks); prints one JSON line per mesh,
then the cards' names and power limits.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2.5-32b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
            "recurrentgemma-2b")
DECODE_STEPS = 3


def grad_rel(cs, arch: str) -> float:
    """The gradient bound: the train phase's card-against-CPU gate."""
    return cs.train_rel(arch)


def _meshes(world: int) -> list:
    return [(world, 1), (2, world // 2), (1, world)] if world >= 4 else [
        (world, 1), (1, world)]


def _reduced(cs, cfg, mesh, dev) -> dict:
    """One reduced arch on ``mesh``: train step and serving against one
    card."""
    import torch

    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw_init

    batch = cs._on(cs.train_batch(cfg, seed=3), dev)
    base = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    params = dict(base.named_parameters())
    loss0, _ = loss_fn(base, batch)
    grads0 = dict(zip(params, torch.autograd.grad(
        loss0, list(params.values()), allow_unused=True,
        materialize_grads=True)))
    # float64 gradients from the same weights: how far each float32 order
    # of summation lies from the exact gradient
    exact = cs._copy_model(base, torch.float64, dev)
    grads64 = dict(zip(params, torch.autograd.grad(
        loss_fn(exact, batch)[0], list(exact.parameters()),
        allow_unused=True, materialize_grads=True)))
    del exact
    base = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    _, _, m0 = make_train_step(cfg, lr=cs.TRAIN_LR, dtype=torch.float32)(
        base, adamw_init(base), batch)
    loss1, grads1, _ = _sharded_grads(
        init_params(cfg, seed=0, dtype=torch.float32, device=dev), batch,
        mesh, cfg)
    _, planted, n_dropped = _sharded_grads(
        init_params(cfg, seed=0, dtype=torch.float32, device=dev), batch,
        mesh, cfg, plant=True)
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    _, _, m1 = make_train_step(cfg, mesh=mesh, lr=cs.TRAIN_LR,
                               dtype=torch.float32)(
        model, adamw_init(model), batch)
    bound = grad_rel(cs, cfg.name)
    out = {"loss_rel": abs(loss1 / float(loss0) - 1),
           "step_loss_rel": abs(float(m1["loss"]) / float(m0["loss"]) - 1),
           "grad_rel": cs.leaf_rel(grads1, grads0), "grad_bound": bound,
           "unsharded_f64_rel": cs.leaf_rel(grads0, grads64),
           "sharded_f64_rel": cs.leaf_rel(grads1, grads64),
           "dropped_reductions": n_dropped,
           "planted_grad_rel": cs.leaf_rel(planted, grads0),
           "int8_equal": _int8_equal(model, grads0, mesh),
           "param_max_abs_err": max(
               float((model.get_parameter(n).full_tensor() - p.detach())
                     .abs().max()) for n, p in base.named_parameters())}
    out["train_ok"] = (out["loss_rel"] <= cs.TRAIN_LOSS_RTOL
                       and out["step_loss_rel"] <= cs.TRAIN_LOSS_RTOL
                       and out["grad_rel"] <= bound and out["int8_equal"]
                       and (n_dropped == 0
                            or out["planted_grad_rel"] > bound))
    plain = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    placed = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (4, cs.SERVE_REDUCED_PROMPT),
                           generator=g).to(dev)
    l0, c0 = make_prefill_step(cfg, dtype=torch.float32)(
        plain, {"tokens": prompt})
    l1, c1 = make_prefill_step(cfg, mesh=mesh, dtype=torch.float32)(
        placed, {"tokens": prompt})
    gaps = [float((l1.full_tensor() - l0).abs().max())]
    d0 = make_decode_step(cfg, dtype=torch.float32)
    d1 = make_decode_step(cfg, mesh=mesh, dtype=torch.float32)
    tok = torch.argmax(l0[:, :cfg.vocab_size], -1)
    for i in range(DECODE_STEPS):
        pos = cs.SERVE_REDUCED_PROMPT + i
        l0, c0 = d0(plain, c0, tok, pos)
        l1, c1 = d1(placed, c1, tok, pos)
        gaps.append(float((l1.full_tensor() - l0).abs().max()))
        tok = torch.argmax(l0[:, :cfg.vocab_size], -1)
    tol = cs.SERVE_LOGIT_TOL
    out["logit_max_abs_err"] = gaps
    out["serve_ok"] = max(gaps) <= tol["atol"] + tol["rtol"] * float(
        l0.abs().max())
    return out


def _sharded_grads(model, batch, mesh, cfg, plant: bool = False):
    """(loss, {name: gradient} as full values, how many pending reductions
    were dropped).  With ``plant``, the planted fault: every pending
    (``Partial``) reduction over a mesh dim of more than one rank in the
    backward is dropped, each rank keeping its own partial sum, both where
    ``Sharder.act`` brings an activation's gradient to its placements and
    where a parameter's gradient leaves autograd."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.steps import (
        _place_batch,
        _sharder,
        place_model,
        state_shardings,
    )
    from repro_torch.models import loss_fn
    from repro_torch.runtime import sharding

    dropped = [0]

    def drop(g):
        sizes = g.device_mesh.shape
        if not plant or not any(p.is_partial() and sizes[i] > 1
                                for i, p in enumerate(g.placements)):
            return g
        dropped[0] += 1
        return DTensor.from_local(
            g.to_local(), g.device_mesh,
            [Replicate() if p.is_partial() else p for p in g.placements],
            run_check=False, shape=g.shape, stride=g.stride())

    def backward(ctx, g):
        return drop(g).redistribute(g.device_mesh, ctx.pl), None

    place_model(model, state_shardings(model, mesh)[0])
    params = dict(model.named_parameters())
    kept = sharding._GradAs.backward
    sharding._GradAs.backward = staticmethod(backward)
    try:
        with implicit_replication():
            loss, _ = loss_fn(model, _place_batch(batch, mesh, cfg),
                              _sharder(cfg, mesh))
            raw = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True,
                                      materialize_grads=True)
    finally:
        sharding._GradAs.backward = staticmethod(kept)
    grads = {n: drop(g).full_tensor() for n, g in zip(params, raw)}
    return float(loss.full_tensor()), grads, dropped[0]


def _int8_equal(model, grads: dict, mesh) -> bool:
    """The int8 round trip of ``grads`` (full values) placed on ``mesh``
    against the unsharded round trip: bit for bit."""
    import torch

    from repro_torch.convert import reference_groups
    from repro_torch.launch.steps import _ef_global, state_shardings
    from repro_torch.optim import ef_roundtrip

    ps = state_shardings(model, mesh)[0]
    err = {n: torch.full_like(g, 1e-3) * (i % 3) for i, (n, g) in
           enumerate(grads.items())}
    groups = reference_groups(model)
    want_g, want_e = ef_roundtrip(grads, err, groups)
    got_g, got_e = _ef_global({n: ps[n].distribute(g) for n, g in
                               grads.items()},
                              {n: ps[n].distribute(e) for n, e in
                               err.items()}, groups, ps)
    return all(torch.equal(got_g[n].full_tensor(), want_g[n])
               and torch.equal(got_e[n].full_tensor(), want_e[n])
               for n in grads)


def _twin_losses(cs, dev, batch) -> list:
    """Two unsharded steps of ``internvl2-1b`` in float32 from the weights
    the bf16 runs start from (drawn in float32, then cast)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get(cs.MESH_FULL)
    twin = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    opt = adamw_init(twin)
    step = make_train_step(cfg, lr=3e-4, dtype=torch.float32)
    losses = [float(step(twin, opt, batch)[2]["loss"]) for _ in range(2)]
    del twin, opt
    torch.cuda.empty_cache()
    return losses


def _full_batch(cs, dev) -> dict:
    import torch

    from repro_torch.configs import get
    from repro_torch.data import SyntheticLM

    cfg = get(cs.MESH_FULL)
    tokens = SyntheticLM(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                         seed=0).batch_at(0)["tokens"][:, :-1]
    return {"tokens": torch.from_numpy(tokens).to(dev)}


def _full(cs, mesh, dev, f32_losses: list) -> dict:
    """``internvl2-1b`` at full width in bf16 on ``mesh``: two steps against
    the unsharded ones and the float32 twin's, then the sharded step
    timed."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get(cs.MESH_FULL)
    batch = _full_batch(cs, dev)
    losses = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        model = cs._copy_model(init_params(cfg, seed=0, dtype=torch.float32,
                                           device=dev), torch.bfloat16, dev)
        opt = adamw_init(model)
        step = make_train_step(cfg, mesh=m, lr=3e-4, dtype=torch.bfloat16)
        losses[name] = [float(step(model, opt, batch)[2]["loss"])
                        for _ in range(2)]
        if m is None:
            del model, opt
            torch.cuda.empty_cache()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    rel = [abs(a / b - 1) for a, b in zip(losses["sharded"],
                                          losses["unsharded"])]
    f32_rel = {name: [abs(a / b - 1) for a, b in zip(ls, f32_losses)]
               for name, ls in losses.items()}
    return {"arch": cfg.name, "losses": {**losses, "f32_twin": f32_losses},
            "loss_rel": rel, "bf16_f32_loss_rel": f32_rel,
            "loss_ok": all(r <= cs.TRAIN_BF16_LOSS_REL
                           for r in f32_rel["sharded"]),
            "step_ms": times, "best_ms": min(times),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev)}


def _rank(rank: int, world: int, store: str, out: str, cpu: bool) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_local_mesh

    rows = []
    try:
        f32 = None if cpu else _twin_losses(cs, dev, _full_batch(cs, dev))
        for shape in _meshes(world):
            t0 = time.perf_counter()
            mesh = make_local_mesh(shape[1], device=dev)
            assert tuple(mesh.shape) == shape, (mesh.shape, shape)
            row = {"mesh": list(shape), "backend": dist.get_backend(),
                   "reduced": {a: _reduced(cs, get(a).reduced(), mesh, dev)
                               for a in FAMILIES}}
            if not cpu:
                row["full"] = _full(cs, mesh, dev, f32)
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def main() -> None:
    import argparse

    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, metavar="RANKS",
                    help="run the reduced archs on this many gloo ranks on "
                         "the CPU instead of the cards")
    args = ap.parse_args()
    cpu = args.cpu > 0
    if cpu:
        world = args.cpu
    elif not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.exit("this script needs two or more GPUs (or --cpu RANKS)")
    else:
        world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        mp.spawn(_rank, args=(world, os.path.join(tmp, "store"), out, cpu),
                 nprocs=world, join=True)
        rows = json.loads(pathlib.Path(out).read_text())
    ok = True
    for row in rows:
        print(json.dumps(row), flush=True)
        ok &= all(r["train_ok"] and r["serve_ok"]
                  for r in row["reduced"].values())
        ok &= cpu or row["full"]["loss_ok"]
    if not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    if not ok:
        sys.exit("a sharded step left its bounds")


if __name__ == "__main__":
    main()
