"""The port's dry run (``launch.dryrun``) and roofline (``roofline``).

One reduced-architecture cell per kind (train / prefill / decode) is traced
on a fake 16 x 16 group: its record has the reference's keys, its bytes
and FLOPs are positive and its collectives are counted.  A cell's
``memory.argument_bytes`` (parameters, ``OptState`` and batch as rank 0
holds them) equals the sum of the reference's per-device shard bytes
(``NamedSharding.shard_shape``) over ``state_shardings`` and
``batch_shardings``, read from a JAX subprocess with 512 forced host
devices (nothing compiled): for the reduced cell traced here, for
``qwen2.5-32b`` at full width on both meshes and for ``mixtral-8x22b`` on
the multi-pod mesh.  ``op_stats`` counts the local shards: a product
sharded four ways counts a quarter of the global FLOPs (a
``FlopCounterMode`` around the same DTensor code counts all of them), and a
model's FLOPs grow by the same amount with each layer (2, 4 and 8 layers;
the reference checks its while-loop trip counts instead).  The roofline
terms and every wire-byte model equal the reference's on the same inputs,
and ``report`` renders a directory of cells.  A train cell traced with
int8 error feedback (the port's option) carries the error memory in its
arguments and the round trip's gathered run in its peak.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as ref_analysis
from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params
from repro_torch.roofline import analysis, report
from repro_torch.roofline.op_stats import OpCounter
from repro_torch.runtime.sharding import local_numel, param_shardings

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = {"train_4k": "qwen2.5-32b", "prefill_32k": "qwen2-moe-a2.7b",
         "decode_32k": "recurrentgemma-2b"}


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
import numpy as np
from repro.configs import get
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import batch_shardings, state_shardings
from repro.models import init_params
from repro.optim.adamw import adamw_init

def shard_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
               for l, s in zip(leaves, shs))

out = {}
for name, arch, reduced, multi in (("reduced", "qwen2.5-32b", True, False),
                                   ("full", "qwen2.5-32b", False, False),
                                   ("full_multi", "qwen2.5-32b", False, True),
                                   ("mixtral_multi", "mixtral-8x22b", False,
                                    True)):
    cfg = get(arch)
    cfg = cfg.reduced() if reduced else cfg
    mesh = make_production_mesh(multi_pod=multi)
    params = jax.eval_shape(
        lambda: init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    opt = jax.eval_shape(lambda: adamw_init(params))
    ps, os_ = state_shardings(params, mesh)
    shape = dr.SHAPES["train_4k"]
    batch = dr.input_specs(cfg, shape)
    bs = batch_shardings(batch, mesh, shape["batch"],
                         all_axes=cfg.family == "rwkv6")
    out[name] = (shard_bytes(params, ps) + shard_bytes(opt, os_)
                 + shard_bytes(batch, bs))
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_bytes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    return {shape: dryrun.run_cell(arch, shape, False,
                                   cfg=get(arch).reduced())
            for shape, arch in CELLS.items()}


@pytest.mark.parametrize("shape", list(CELLS))
def test_reduced_cell_per_kind(cells, shape):
    d = cells[shape]
    assert d["status"] == "ok" and d["n_devices"] == 256
    assert d["mesh"] == "pod16x16" and d["shape"] == shape
    for key in ("family", "params", "active_params", "trace_s", "memory",
                "op_stats", "model_flops_total", "model_flops_per_device",
                "useful_flops_ratio", "roofline"):
        assert key in d, key
    mem, st = d["memory"], d["op_stats"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert st["flops_per_device"] > 0 and st["hbm_bytes_per_device"] > 0
    assert st["wire_bytes_per_device"] > 0 and st["collectives"]
    for c in st["collectives"]:
        assert c["kind"] in ("all-reduce", "all-gather", "reduce-scatter",
                             "all-to-all") and c["group"] == 16
    assert d["model_flops_per_device"] == d["model_flops_total"] / 256
    r = d["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["compute_s"] == st["flops_per_device"] / 989e12
    assert ("microbatches" in d) == (shape == "train_4k")
    json.dumps(d)


def test_argument_bytes_equal_reference(reference_bytes, cells):
    assert cells["train_4k"]["memory"]["argument_bytes"] == (
        reference_bytes["reduced"])
    assert dryrun.argument_bytes(get("qwen2.5-32b"), "train_4k") == (
        reference_bytes["full"])
    assert dryrun.argument_bytes(get("qwen2.5-32b"), "train_4k", True) == (
        reference_bytes["full_multi"])
    assert dryrun.argument_bytes(get("mixtral-8x22b"), "train_4k", True) == (
        reference_bytes["mixtral_multi"])


def test_int8_cell_carries_the_error_memory_and_its_round_trip(cells):
    """With int8 error feedback a train cell's arguments gain the float32
    error memory (placed as the parameters), and its peak covers the round
    trip's gathered run: the largest parameter's full error memory and
    corrected gradient, both float32."""
    cfg = get(CELLS["train_4k"]).reduced()
    shape = dryrun.SHAPES["train_4k"]
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        with FakeTensorMode():
            _, plain, _ = dryrun._trace(cfg, shape, mesh, {}, run=False)
            _, int8, _ = dryrun._trace(cfg, shape, mesh, {}, run=False,
                                       grad_compression=True)
            model = init_params(cfg, seed=0, dtype=torch.bfloat16,
                                device="cpu")
            ps = param_shardings(model, mesh)
            local = sum(local_numel(p.shape, mesh, ps[n].placements)
                        for n, p in model.named_parameters())
            biggest = max(p.numel() for p in model.parameters())
    assert plain == cells["train_4k"]["memory"]["argument_bytes"]
    assert int8 - plain == 4 * local
    d = dryrun.run_cell(CELLS["train_4k"], "train_4k", False, cfg=cfg,
                        grad_compression=True)
    assert d["status"] == "ok" and d["grad_compression"] == "int8"
    assert d["memory"]["argument_bytes"] == int8
    assert d["memory"]["peak_bytes"] >= int8 + 8 * biggest
    assert d["memory"]["peak_bytes"] > cells["train_4k"]["memory"][
        "peak_bytes"]
    with pytest.raises(ValueError, match="not a train shape"):
        dryrun.run_cell(CELLS["decode_32k"], "decode_32k", False,
                        cfg=get(CELLS["decode_32k"]).reduced(),
                        grad_compression=True)


@pytest.fixture
def fake_four():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_op_stats_count_the_local_shard(fake_four):
    m, k, n = 256, 4096, 512
    with FakeTensorMode():
        a = distribute_tensor(torch.zeros(m, k), fake_four, [Shard(0)],
                              src_data_rank=None)
        b = distribute_tensor(torch.zeros(k, n), fake_four, [Replicate()],
                              src_data_rank=None)
        with OpCounter() as counter:
            c = a @ b
        with FlopCounterMode(display=False) as flops:
            a @ b
    assert tuple(c.to_local().shape) == (m // 4, n)
    assert counter.stats.flops == 2 * m * k * n / 4
    assert flops.get_total_flops() == 2 * m * k * n  # the global count
    assert counter.stats.hbm_bytes == 4 * (m // 4 * k + k * n + m // 4 * n)
    assert counter.stats.wire_bytes == 0


def test_flops_grow_by_the_same_amount_per_layer():
    shape = {"kind": "train", "seq": 64, "batch": 32}
    flops = {}
    for layers in (2, 4, 8):
        cfg = dataclasses.replace(get("minitron-8b").reduced(),
                                  n_layers=layers)
        with dryrun.fake_world(256):
            mesh = make_production_mesh(device="cpu")
            with FakeTensorMode():
                counter, _, _ = dryrun._trace(cfg, shape, mesh, {})
        flops[layers] = counter.stats.flops
    per_layer = (flops[4] - flops[2]) / 2
    assert per_layer > 0
    assert flops[8] - flops[4] == 4 * per_layer


def test_roofline_terms_and_wire_bytes_equal_reference():
    hw = analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 50e9)
    ref_hw = ref_analysis.HW()
    same = analysis.HW(ref_hw.peak_flops, ref_hw.hbm_bw, ref_hw.link_bw)
    for args in ((1e15, 2e12, 3e9), (0.0, 5e11, 0.0), (2e13, 0.0, 7e10)):
        for eff in (1.0, 0.43):
            assert analysis.roofline_terms(*args, same, eff) == (
                ref_analysis.roofline_terms(*args, ref_hw, eff))
    ops = []
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute", "send"):
        for size in (1, 2, 16, 512):
            ref = ref_analysis.CollectiveOp(kind, 12345678, size, 3)
            got = analysis.CollectiveOp(kind, 12345678, size, 3)
            assert got.wire_bytes() == ref.wire_bytes(), (kind, size)
            ops.append((got, ref))
    assert analysis.collective_wire_bytes([g for g, _ in ops], 2.0) == (
        ref_analysis.collective_wire_bytes([r for _, r in ops], 2.0))


def test_report_renders_a_directory_of_cells(cells, tmp_path):
    for d in cells.values():
        (tmp_path / f"{d['arch']}__{d['shape']}__{d['mesh']}.json").write_text(
            json.dumps(d))
    skipped = dryrun.run_cell("qwen2.5-32b", "long_500k", False)
    assert skipped["status"] == "skipped"
    (tmp_path / "qwen2.5-32b__long_500k__pod16x16.json").write_text(
        json.dumps(skipped))
    (tmp_path / "x__train_4k__pod16x16.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "mesh": "pod16x16",
         "status": "error"}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert lines[0].split()[:3] == ["arch", "shape", "mesh"]
    assert len(lines) == 1 + len(cells) + 2
    assert any("skipped" in ln for ln in lines)
    assert any(ln.endswith("ERROR") for ln in lines)
    for d in cells.values():
        row = next(ln for ln in lines
                   if ln.split()[:2] == [d["arch"], d["shape"]])
        assert d["roofline"]["dominant"][:6] in row.split()
    d = cells["train_4k"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(tmp_path), "--cell", d["arch"], d["shape"],
                     d["mesh"], "--collectives"])
    text = buf.getvalue()
    assert json.loads(text[:text.rindex("}") + 1])["status"] == "ok"
    assert "group=  16" in text
