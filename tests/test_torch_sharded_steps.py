"""The sharded train step on four gloo ranks against the unsharded port.

Each case spawns four CPU processes (``torch.multiprocessing.spawn``, a
``FileStore`` under ``tmp_path``, the gloo backend); rank 0 writes what the
mesh computed as full values (``DTensor.full_tensor``) and the test holds
them against the port's unsharded step on the same weights (``seed=0``)
and the same numpy-drawn batch.  One reduced architecture per family
(dense, MoE, RWKV-6, RG-LRU hybrid) at (2, 2) and at (4, 1); at (1, 4) two
dense configs take the attention's other two layouts (a kv head read by
the q heads of several ranks; context parallelism, where the head count
does not divide the axis).  Bounds, each set above the largest gap read on
this machine (in brackets, over every case):

- the loss: rtol 1e-6 [1.4e-7];
- every gradient leaf: the largest difference within 1e-5 of the leaf's
  largest magnitude [4.4e-6];
- the parameters after one AdamW step at lr 1e-3: atol 3e-4, as in
  ``test_torch_train.py`` [6.8e-5]; ``mu`` as the gradients [4.4e-6],
  ``nu`` twice that [5.6e-6];
- ``microbatches=2`` with int8 error feedback: the loss rtol 1e-6
  [7.2e-8], the parameters atol 3e-4 plus lr, for a weight whose block's
  rounding flips [1.0e-3], the error memory within one quantum (its
  block's scale) of the unsharded step's; given the same global gradients
  the sharded round trip's int8 blocks, scales, decompressed gradients and
  memory equal the unsharded ones bit for bit, also when a group is
  gathered a block-aligned run of tensors at a time (a one-rank mesh).

A checkpoint written at (2, 2) holds the step's full values, is read by the
reference's ``load_pytree``, and restores bit for bit onto (4, 1), onto a
one-rank mesh and into an unsharded model.  The reference's own sharded
loss on a (2, 2) mesh of four forced host devices, from its weights, is
met within rtol 1e-5 [7.1e-8].
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.checkpoint.manager import load_pytree as ref_load_pytree
from repro_torch.checkpoint.manager import load_pytree
from repro_torch.configs import get
from repro_torch.convert import reference_groups
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step, state_shardings
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import adamw_init, compress, ef_init, ef_roundtrip

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2.5-32b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
            "recurrentgemma-2b")
LR = 1e-3
LOSS_RTOL, GRAD_REL, PARAM_ATOL, REF_RTOL = 1e-6, 1e-5, 3e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64))}


def _cfg(arch: str):
    return get(arch).reduced()


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #


def _full(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor().detach().clone()
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _sharded_grads(model, batch, mesh, cfg):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.steps import (
        _place_batch,
        _sharder,
        place_model,
    )

    place_model(model, state_shardings(model, mesh)[0])
    params = dict(model.named_parameters())
    with implicit_replication():
        loss, _ = loss_fn(model, _place_batch(batch, mesh, cfg),
                          _sharder(cfg, mesh))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, params.values())]
    return _full(loss), dict(zip(params, _full(dict(zip(params, grads)))
                                 .values()))


def _case(cfg, mesh, out: dict, key: str, extras: bool, ckpt=None):
    from repro_torch.checkpoint.manager import save_pytree
    from repro_torch.launch.steps import _ef_global, place_state

    batch = _batch(cfg)
    loss, grads = _sharded_grads(init_params(cfg, seed=0, device="cpu"),
                                 batch, mesh, cfg)
    model = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(model)
    _, opt, m = make_train_step(cfg, mesh=mesh, lr=LR,
                                dtype=torch.float32)(model, opt, batch)
    out[key] = {"loss": loss, "grads": grads,
                "step": {"loss": m["loss"], "grad_norm": m["grad_norm"],
                         "params": _full(dict(model.named_parameters())),
                         "mu": _full(opt.mu), "nu": _full(opt.nu)}}
    if ckpt is not None:
        save_pytree({"params": dict(model.named_parameters()), "opt": opt},
                    ckpt)
    if not extras:
        return
    model = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(model)
    ps = place_state(model, opt, mesh)
    err = ef_init(model)
    _, opt, m, err = make_train_step(
        cfg, mesh=mesh, microbatches=2, lr=LR, grad_compression=True,
        dtype=torch.float32)(model, opt, batch, err)
    out[key]["mb2_int8"] = {"loss": m["loss"], "ef": _full(err),
                            "params": _full(dict(model.named_parameters()))}
    # the round trip alone, from the same global gradients
    zero = {n: torch.zeros_like(g) for n, g in grads.items()}
    deq, new = _ef_global({n: ps[n].distribute(g) for n, g in grads.items()},
                          {n: ps[n].distribute(z) for n, z in zero.items()},
                          reference_groups(model), ps)
    out[key]["ef_roundtrip"] = {"deq": _full(deq), "err": _full(new)}


def _restore(cfg, mesh, ckpt, out: dict) -> None:
    from repro_torch.launch.steps import place_state

    model = init_params(cfg, seed=1, device="cpu")
    opt = adamw_init(model)
    place_state(model, opt, mesh)
    target = {"params": dict(model.named_parameters()), "opt": opt}
    kept, _ = load_pytree(ckpt, target)  # the leaves' own placements
    ps, os_ = state_shardings(model, mesh)
    given, _ = load_pytree(ckpt, target, {"params": ps, "opt": os_})
    out["restore"] = {
        name: {"params": _full(t["params"]), "mu": _full(t["opt"].mu),
               "nu": _full(t["opt"].nu), "step": _full(t["opt"].step),
               "placed": all(tuple(p.placements) == ps[n].placements
                             for n, p in t["params"].items())}
        for name, t in (("kept", kept), ("given", given))}


def _rank(rank: int, world: int, store: str, out_dir: str, job: dict):
    import warnings

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        for shape, cases in job["meshes"]:
            mesh = make_local_mesh(shape[1], device="cpu")
            assert tuple(mesh.shape) == tuple(shape)
            for arch, extras in cases:
                ckpt = (os.path.join(out_dir, "ckpt")
                        if job.get("save") == arch else None)
                _case(_cfg(arch), mesh, out, f"{arch}@{shape}", extras, ckpt)
        if "restore" in job:
            mesh = make_local_mesh(job["restore"][1], device="cpu")
            _restore(_cfg(job["save_arch"]), mesh,
                     os.path.join(out_dir, "ckpt"), out)
        if "reference" in job:
            from repro_torch.convert import lm_params_from_numpy

            cfg = _cfg("qwen2.5-32b")
            with open(job["reference"], "rb") as f:
                tree = pickle.load(f)
            model = lm_params_from_numpy(cfg, tree, device="cpu")
            mesh = make_local_mesh(2, device="cpu")
            loss, _ = _sharded_grads(model, {"tokens": torch.from_numpy(
                np.load(job["tokens"]))}, mesh, cfg)
            out["reference_loss"] = loss
        if rank == 0:
            torch.save(out, os.path.join(out_dir, job["name"] + ".pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, job: dict) -> dict:
    store = tmp_path / f"store_{job['name']}"
    mp.spawn(_rank, args=(4, str(store), str(tmp_path), job), nprocs=4,
             join=True)
    return torch.load(tmp_path / (job["name"] + ".pt"), weights_only=False)


# --------------------------------------------------------------------------- #
# the unsharded port
# --------------------------------------------------------------------------- #


def _unsharded(arch: str) -> dict:
    cfg = _cfg(arch)
    batch = _batch(cfg)
    model = init_params(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    model = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(model)
    _, opt, m = make_train_step(cfg, lr=LR, dtype=torch.float32)(
        model, opt, batch)
    rec = {"loss": loss.detach(), "grads": dict(zip(params, grads)),
           "step": {"loss": m["loss"], "params": dict(model.named_parameters()),
                    "mu": opt.mu, "nu": opt.nu}}
    model = init_params(cfg, seed=0, device="cpu")
    opt, err = adamw_init(model), ef_init(model)
    _, _, m, err = make_train_step(cfg, microbatches=2, lr=LR,
                                   grad_compression=True,
                                   dtype=torch.float32)(model, opt, batch, err)
    stepped = dict(model.named_parameters())
    # the corrected gradient the int8 round trip blocks (the microbatches'
    # mean; the memory starts at zero)
    model = init_params(cfg, seed=0, device="cpu")
    halves = [torch.autograd.grad(
        loss_fn(model, {k: v[i:i + 2] for k, v in batch.items()})[0],
        list(model.parameters()), allow_unused=True, materialize_grads=True)
        for i in (0, 2)]
    rec["mb2_int8"] = {"loss": m["loss"], "ef": err, "params": stepped,
                       "corrected": {n: (a + b) / 2 for n, a, b in zip(
                           params, *halves)}}
    return rec


def _rel(got: dict, want: dict) -> float:
    worst = 0.0
    for n, w in want.items():
        w = w.detach()
        gap = float((got[n] - w).abs().max())
        top = float(w.abs().max())
        worst = max(worst, gap / top if top else gap)
    return worst


def _max_abs(got: dict, want: dict) -> float:
    return max(float((got[n] - w.detach()).abs().max())
               for n, w in want.items())


def _check(got: dict, want: dict, what: str) -> None:
    assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= LOSS_RTOL, what
    assert _rel(got["grads"], want["grads"]) <= GRAD_REL, what
    s, w = got["step"], want["step"]
    assert abs(float(s["loss"]) / float(w["loss"]) - 1) <= LOSS_RTOL, what
    assert _max_abs(s["params"], w["params"]) <= PARAM_ATOL, what
    assert _rel(s["mu"], w["mu"]) <= GRAD_REL, what
    assert _rel(s["nu"], w["nu"]) <= 2 * GRAD_REL, what


def _check_int8(arch: str, got: dict, want: dict) -> None:
    g, w = got["mb2_int8"], want["mb2_int8"]
    assert abs(float(g["loss"]) / float(w["loss"]) - 1) <= LOSS_RTOL, arch
    assert _max_abs(g["params"], w["params"]) <= PARAM_ATOL + LR, arch
    model = init_params(_cfg(arch), seed=0, device="cpu")
    for names in reference_groups(model):
        flat = torch.cat([w["corrected"][n].reshape(-1) for n in names])
        quantum = float(compress(flat)[1].max())
        gap = max(float((g["ef"][n] - w["ef"][n]).abs().max())
                  for n in names)
        assert gap <= max(quantum, 1e-12), (arch, names[0], gap, quantum)
    # the round trip from the same global gradients: bit for bit
    zero = {n: torch.zeros_like(t) for n, t in got["grads"].items()}
    groups = reference_groups(model)
    deq, err = ef_roundtrip(got["grads"], zero, groups)
    rt = got["ef_roundtrip"]
    for n in deq:
        assert torch.equal(rt["deq"][n], deq[n]), (arch, n)
        assert torch.equal(rt["err"][n], err[n]), (arch, n)
    for names in groups:
        flat = torch.cat([got["grads"][n].reshape(-1) for n in names])
        q0, s0 = compress(flat)
        q1, s1 = compress(torch.cat([(rt["deq"][n] + rt["err"][n])
                                     .reshape(-1) for n in names]))
        assert torch.equal(q0, q1) and torch.equal(s0, s1), (arch, names[0])


_REFERENCE = r'''
import os, pickle, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get
from repro.launch.steps import batch_shardings, state_shardings
from repro.models import init_params, loss_fn
from repro.runtime.sharding import Sharder
out = sys.argv[1]
cfg = get("qwen2.5-32b").reduced()
params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 16))
tokens = tokens.astype(np.int32)
# make_local_mesh's jax.make_mesh gives Explicit axes in this JAX, which
# with_sharding_constraint refuses: the same mesh with Auto axes
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
ps, _ = state_shardings(params, mesh)
batch = {"tokens": tokens}
with mesh:
    f = jax.jit(lambda p, b: loss_fn(p, b, cfg, Sharder(mesh),
                                     dtype=jnp.float32)[0],
                in_shardings=(ps, batch_shardings(batch, mesh, 4)))
    loss = float(f(params, batch))
with open(os.path.join(out, "ref_params.pkl"), "wb") as fh:
    pickle.dump(jax.tree_util.tree_map(np.asarray, params), fh)
np.save(os.path.join(out, "ref_tokens.npy"), tokens.astype(np.int64))
print(json.dumps({"loss": loss}))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    a = _spawn(tmp, {
        "name": "a", "save": "qwen2.5-32b",
        "meshes": [((2, 2), [(arch, True) for arch in FAMILIES])],
        "reference": str(tmp / "ref_params.pkl"),
        "tokens": str(tmp / "ref_tokens.npy")})
    b = _spawn(tmp, {
        "name": "b", "restore": (4, 1), "save_arch": "qwen2.5-32b",
        "meshes": [((4, 1), [(arch, False) for arch in FAMILIES]),
                   ((1, 4), [("qwen2.5-32b", False),
                             ("internvl2-1b", False)])]})
    return {"dir": tmp, "a": a, "b": b,
            "reference_loss": json.loads(ref.stdout.strip().splitlines()[-1])
            ["loss"]}


@pytest.fixture(scope="module")
def unsharded():
    return {arch: _unsharded(arch) for arch in (*FAMILIES, "internvl2-1b")}


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_at_2x2_equals_unsharded(runs, unsharded, arch):
    _check(runs["a"][f"{arch}@(2, 2)"], unsharded[arch], f"{arch} (2, 2)")


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_at_4x1_equals_unsharded(runs, unsharded, arch):
    _check(runs["b"][f"{arch}@(4, 1)"], unsharded[arch], f"{arch} (4, 1)")


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "internvl2-1b"])
def test_attention_layouts_at_1x4_equal_unsharded(runs, unsharded, arch):
    cfg = _cfg(arch)
    hq = cfg.n_heads + cfg.head_pad
    # qwen: 12 q heads over 4 ranks read 2 kv heads that do not divide the
    # axis; internvl2: 6 q heads do not divide it (context parallelism)
    assert (hq % 4 == 0) == (arch == "qwen2.5-32b") and cfg.n_kv_heads % 4
    _check(runs["b"][f"{arch}@(1, 4)"], unsharded[arch], f"{arch} (1, 4)")


@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatches_and_int8_at_2x2(runs, unsharded, arch):
    _check_int8(arch, runs["a"][f"{arch}@(2, 2)"], unsharded[arch])


def test_int8_round_trip_gathers_one_block_aligned_run_at_a_time(
        monkeypatch):
    """Under a mesh the round trip gathers a group's tensors a run at a
    time, each run ending where an int8 block does, and its result equals
    the whole group's round trip bit for bit (a one-rank mesh)."""
    from repro_torch.launch import steps
    from repro_torch.runtime.sharding import Sharding

    sizes = {"a": 100, "b": 156, "c": 300, "d": 212, "e": 50, "f": 256}
    groups = [["a", "b", "c", "d", "e"], ["f"]]
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(k, generator=g) for n, k in sizes.items()}
    err = {n: torch.randn(k, generator=g) * 1e-3 for n, k in sizes.items()}
    want = ef_roundtrip(grads, err, groups)
    runs, real = [], steps.ef_roundtrip

    def spy(gr, er, grps):
        runs.extend(grps)
        return real(gr, er, grps)

    monkeypatch.setattr(steps, "ef_roundtrip", spy)
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")
        sh = {n: Sharding(mesh, (None,)) for n in sizes}
        got = steps._ef_global({n: sh[n].distribute(t)
                                for n, t in grads.items()},
                               {n: sh[n].distribute(t)
                                for n, t in err.items()}, groups, sh)
        got = [{n: t.full_tensor() for n, t in d.items()} for d in got]
    finally:
        dist.destroy_process_group()
    assert runs == [["a", "b"], ["c", "d"], ["e"], ["f"]]
    for n in sizes:
        assert torch.equal(got[0][n], want[0][n]), n
        assert torch.equal(got[1][n], want[1][n]), n


def test_checkpoint_reshards_bit_for_bit(runs):
    ckpt = runs["dir"] / "ckpt"
    saved = runs["a"]["qwen2.5-32b@(2, 2)"]["step"]
    ref_arrays, _ = ref_load_pytree(ckpt)
    arrays, _ = load_pytree(ckpt)
    assert set(ref_arrays) == set(arrays)
    for n, t in saved["params"].items():
        assert np.array_equal(ref_arrays[f"params/{n}"], t.numpy()), n
        assert np.array_equal(ref_arrays[f"opt/mu/{n}"],
                              saved["mu"][n].numpy()), n
    # onto (4, 1), with the target's own placements and with shardings given
    for how in ("kept", "given"):
        got = runs["b"]["restore"][how]
        assert got["placed"]
        for n, t in saved["params"].items():
            assert torch.equal(got["params"][n], t), (how, n)
            assert torch.equal(got["mu"][n], saved["mu"][n]), (how, n)
            assert torch.equal(got["nu"][n], saved["nu"][n]), (how, n)
        assert int(got["step"]) == 1
    # onto a one-rank mesh, and into an unsharded model
    cfg = _cfg("qwen2.5-32b")
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")
        model = init_params(cfg, seed=1, device="cpu")
        opt = adamw_init(model)
        ps, os_ = state_shardings(model, mesh)
        tree, _ = load_pytree(ckpt, {"params": dict(model.named_parameters()),
                                     "opt": opt}, {"params": ps, "opt": os_})
        for n, t in saved["params"].items():
            assert tuple(tree["params"][n].placements) == ps[n].placements
            assert torch.equal(tree["params"][n].full_tensor(), t), n
    finally:
        dist.destroy_process_group()
    model = init_params(cfg, seed=1, device="cpu")
    tree, _ = load_pytree(ckpt, {"params": dict(model.named_parameters()),
                                 "opt": adamw_init(model)})
    for n, t in saved["params"].items():
        assert type(tree["params"][n]) is torch.nn.Parameter
        assert torch.equal(tree["params"][n].detach(), t), n


def test_sharded_loss_equals_reference_sharded_loss(runs):
    got = float(runs["a"]["reference_loss"])
    want = runs["reference_loss"]
    assert abs(got / want - 1) <= REF_RTOL, (got, want)
