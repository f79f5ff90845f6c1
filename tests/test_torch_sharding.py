"""The port's sharding rules against the reference's, spec by spec.

A JAX subprocess with 512 forced host devices (the reference's dry-run
setup; nothing is compiled) prints the reference's ``NamedSharding`` specs
for all ten architectures at full width (``jax.eval_shape``), at
``make_production_mesh()`` and at ``multi_pod=True``: every parameter leaf
of ``state_shardings``, every cache leaf of ``cache_shardings`` and every
input of ``batch_shardings`` for each ``SHAPES`` entry.  The port builds the
same models on fake tensors and the same meshes over a fake process group
of 512 ranks, and its specs must equal the reference's exactly: each port
parameter through its reference leaf (``convert.reference_leaves``; a
per-layer tensor's spec is the stacked leaf's without its leading layer
entry), each cache leaf likewise by its name.  The placements are then
checked against the reference's spec independently: ``Shard(d)`` on every
mesh dim that dim d names, ``Replicate()`` elsewhere.  ``fit_spec`` equals
the reference's on the same duck-typed mesh as a property.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from _property import given, settings, st
from repro.runtime.sharding import fit_spec as ref_fit_spec
from repro_torch.configs import get, names
from repro_torch.convert import reference_leaves
from repro_torch.launch.dryrun import SHAPES, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import batch_shardings, cache_shardings
from repro_torch.models import init_cache, init_params
from repro_torch.runtime.sharding import fit_spec, param_shardings

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

_REFERENCE = r'''
import json
import repro.launch.dryrun as dr  # sets the 512-device flag before jax starts
import jax
import jax.numpy as jnp
from repro.configs import get, names
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import batch_shardings, cache_shardings, state_shardings
from repro.models import init_cache, init_params

def spec(sh):
    return [e if e is None or isinstance(e, str) else list(e) for e in sh.spec]

def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))

out = {}
meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
for arch in names():
    cfg = get(arch)
    params = jax.eval_shape(
        lambda: init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    caches = {name: jax.eval_shape(
        lambda: init_cache(cfg, s["batch"], s["seq"], jnp.bfloat16))
        for name, s in dr.SHAPES.items()}
    for multi, mesh in meshes.items():
        ps, _ = state_shardings(params, mesh)
        rec = {"params": {"/".join(key(k) for k in path): spec(s)
                          for path, s in
                          jax.tree_util.tree_flatten_with_path(ps)[0]},
               "caches": {}, "batches": {}}
        for name, s in dr.SHAPES.items():
            b = s["batch"]
            leaves = {}
            for path, sh in jax.tree_util.tree_flatten_with_path(
                    cache_shardings(caches[name], mesh, b))[0]:
                leaf = key(path[-1])
                assert leaves.setdefault(leaf, spec(sh)) == spec(sh), leaf
            rec["caches"][name] = leaves
            io = dr.input_specs(cfg, s)
            if s["kind"] == "decode":
                rec["batches"][name] = {
                    "token": spec(batch_shardings(io["token"], mesh, b))}
            else:
                bs = batch_shardings(io, mesh, b,
                                     all_axes=cfg.family == "rwkv6")
                rec["batches"][name] = {k: spec(v) for k, v in bs.items()}
        out[f"{arch}|{int(multi)}"] = rec
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def meshes():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {m: make_production_mesh(multi_pod=m, device="cpu")
               for m in (False, True)}
    finally:
        dist.destroy_process_group()


def _norm(spec) -> tuple:
    """A spec with tuples for multi-axis entries and no trailing Nones."""
    out = [tuple(e) if isinstance(e, list) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _expected_placements(spec, mesh) -> tuple:
    spec = _norm(spec)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


CASES = [(arch, multi) for arch in names() for multi in (False, True)]


@pytest.mark.parametrize("arch,multi", CASES)
def test_param_specs_equal_reference(reference, meshes, arch, multi):
    mesh = meshes[multi]
    ref = reference[f"{arch}|{int(multi)}"]["params"]
    with FakeTensorMode():
        model = init_params(get(arch), seed=0, dtype=torch.bfloat16,
                            device="cpu")
    shardings = param_shardings(model, mesh)
    leaves = reference_leaves(model)
    assert set(shardings) == set(leaves)
    assert {path for path, _, _ in leaves.values()} == set(ref)
    sharded = 0
    for name, sh in shardings.items():
        path, _, stacked = leaves[name]
        want = _norm(ref[path])
        if stacked:
            assert not want or want[0] is None, (path, want)
            want = want[1:]
        assert _norm(sh.spec) == _norm(want), (name, sh.spec, want)
        assert sh.placements == _expected_placements(want, mesh), name
        sharded += any(isinstance(p, Shard) for p in sh.placements)
    assert sharded > len(shardings) // 3  # the rules do shard


@pytest.mark.parametrize("arch,multi", CASES)
def test_cache_and_batch_specs_equal_reference(reference, meshes, arch,
                                               multi):
    mesh = meshes[multi]
    ref = reference[f"{arch}|{int(multi)}"]
    cfg = get(arch)
    for name, shape in SHAPES.items():
        b, s = shape["batch"], shape["seq"]
        with FakeTensorMode():
            caches = init_cache(cfg, b, s, dtype=torch.bfloat16, device="cpu")
            inputs = {k: torch.zeros(sh, dtype=dt)
                      for k, (sh, dt) in input_specs(cfg, shape).items()}
        for layer in cache_shardings(caches, mesh, b):
            for leaf, sh in layer.items():
                want = _norm(ref["caches"][name][leaf])
                assert not want or want[0] is None
                assert _norm(sh.spec) == _norm(want[1:]), (name, leaf)
                assert sh.placements == _expected_placements(want[1:], mesh)
        if shape["kind"] == "decode":
            got = {"token": batch_shardings(inputs["token"], mesh, b)}
        else:
            got = batch_shardings(inputs, mesh, b,
                                  all_axes=cfg.family == "rwkv6")
        assert set(got) == set(ref["batches"][name])
        for k, sh in got.items():
            assert _norm(sh.spec) == _norm(ref["batches"][name][k]), (name, k)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_fit_spec_equals_reference(seed):
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(seed)
    names_ = ("pod", "data", "model")[int(rng.integers(0, 2)):]
    sizes = {n: int(rng.choice([1, 2, 3, 4, 8, 16])) for n in names_}
    mesh = types.SimpleNamespace(shape=sizes, axis_names=names_)
    rank = int(rng.integers(1, 5))
    shape = tuple(int(rng.choice([1, 2, 3, 6, 8, 12, 16, 48, 64, 256]))
                  for _ in range(rank))
    free = list(names_)
    rng.shuffle(free)
    spec = []
    for _ in range(int(rng.integers(0, rank + 1))):
        pick = rng.integers(0, 3)
        if pick == 0 or not free:
            spec.append(None)
        elif pick == 1:
            spec.append(free.pop())
        else:
            k = int(rng.integers(1, len(free) + 1))
            spec.append(tuple(sorted(free[:k], key=names_.index)))
            free = free[k:]
    want = tuple(ref_fit_spec(P(*spec), shape, mesh))
    assert fit_spec(tuple(spec), shape, mesh) == want


def test_reference_leaves_cover_every_parameter():
    cfg = get("recurrentgemma-2b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    leaves = reference_leaves(model)
    assert set(leaves) == {n for n, _ in model.named_parameters()}
    path, shape, stacked = leaves["blocks.2.attn.wq"]
    assert path == "periods/attn/attn/wq" and stacked
    assert shape[0] == cfg.n_layers // 3
    assert leaves["embed"] == ("embed", tuple(model.embed.shape), False)
