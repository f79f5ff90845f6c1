"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's jitted step on 512 forced host devices.  The port's
counterpart: a fake process group (``torch.testing``'s ``FakeStore`` and
the ``fake`` backend) of 256 or 512 ranks, this process as rank 0, the
production mesh over it, and the step of ``launch.steps`` run under
``FakeTensorMode``: parameters, optimizer state, batch and caches are
fake tensors placed by the same shardings as a real run, every op runs on
rank 0's local shards for its shapes only, and no memory is allocated on
any device.  This is the one entry point that needs no card.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # resumable
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys where their meaning carries over: ``status``,
``n_devices``, ``family``, ``params``, ``active_params``, ``microbatches``;
``memory.argument_bytes`` (the exact per-rank bytes of the local shards of
the parameters, the ``OptState``, the batch and the cache) and
``memory.peak_bytes`` (the most live fake-tensor bytes the op counter
saw); ``op_stats`` (``roofline.op_stats``: per-device FLOPs, HBM bytes,
wire bytes and the top 20 collectives); the analytic model FLOPs
(6 N T train, 2 N T prefill, 2 N b decode); ``useful_flops_ratio`` and the
three roofline terms with the H100's constants.  The reference's
``lower_s`` and ``compile_s`` become ``trace_s``; its
``xla_cost_analysis`` (XLA's own per-body counts) has no counterpart.

``--grad-compression int8`` (not in the reference, whose dry run traces
no compression) traces a train cell with the int8 error feedback on: its
error memory (float32, placed as the parameters) joins the argument
bytes, the peak covers the round trip's gathered runs, and the cell is
written as ``<arch>__<shape>__<mesh>__int8.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import get, names
from ..models import init_cache, init_params
from ..models.frontends import N_VIT_PATCHES
from ..optim.adamw import adamw_init
from ..optim.compression import ef_init
from ..roofline.analysis import HW, roofline_terms
from ..roofline.op_stats import OpCounter, tensor_bytes
from ..runtime.sharding import local_numel
from .mesh import make_production_mesh
from .steps import (
    batch_shardings,
    cache_shardings,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    place_model,
    state_shardings,
)

__all__ = ["SHAPES", "argument_bytes", "fake_world", "input_specs", "main",
           "microbatches_for", "run_cell"]

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def microbatches_for(cfg, shape) -> int:
    if shape["kind"] != "train":
        return 1
    n = cfg.param_count()
    if cfg.family == "rwkv6":
        return 1  # §Perf R2: full-mesh DP needs the whole batch in one piece
    if cfg.family == "moe" and n > 2e10:
        return 8  # mixtral: remat carries cap the microbatch size
    if n > 2e10:
        return 4  # §Perf Q3: fewer microbatches = fewer per-layer collectives
    if n > 5e9:
        return 4
    return 2


def input_specs(cfg, shape) -> dict:
    """``{name: (shape, dtype)}`` of every model input of this cell."""
    b, s = shape["batch"], shape["seq"]
    if shape["kind"] in ("train", "prefill"):
        if cfg.frontend == "vit":
            return {
                "inputs_embeds": ((b, N_VIT_PATCHES, cfg.d_model),
                                  torch.bfloat16),
                "tokens": ((b, s - N_VIT_PATCHES), torch.int32),
            }
        if cfg.frontend == "encodec":
            return {
                "inputs_embeds": ((b, s, cfg.d_model), torch.bfloat16),
                "labels": ((b, s), torch.int32),
            }
        return {"tokens": ((b, s), torch.int32)}
    # decode
    return {"token": ((b,), torch.int32), "pos": ((), torch.int32)}


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks with this process as rank 0:
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the dry run "
                           "makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(t: torch.Tensor, sharding=None) -> int:
    """Bytes of this rank's shard: of a DTensor as placed, of a plain
    tensor as ``sharding`` would place it."""
    if isinstance(t, DTensor):
        return tensor_bytes(t.to_local())
    if sharding is None:
        return tensor_bytes(t)
    return local_numel(t.shape, sharding.mesh,
                       sharding.placements) * t.element_size()


def _fake_inputs(specs: dict) -> dict:
    return {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
            specs.items()}


def _trace(cfg, shape, mesh, extra: dict, run: bool = True,
           grad_compression: bool = False):
    """Place the cell's state on ``mesh`` and run its step under an
    ``OpCounter`` (with ``run`` false, only place it); a train step with
    ``grad_compression`` also carries the int8 error memory.  Returns
    (counter, argument bytes, output bytes)."""
    b, s = shape["batch"], shape["seq"]
    rwkv = cfg.family == "rwkv6"
    model = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    ps, _ = state_shardings(model, mesh)
    place_model(model, ps)
    arg = sum(_local_bytes(p) for p in model.parameters())
    if shape["kind"] == "train":
        mb = microbatches_for(cfg, shape)
        extra["microbatches"] = mb
        opt = adamw_init(model)
        arg += sum(_local_bytes(t) for t in (*opt.mu.values(),
                                             *opt.nu.values(), opt.step))
        batch = _fake_inputs(input_specs(cfg, shape))
        sh = batch_shardings(batch, mesh, b, all_axes=rwkv)
        arg += sum(_local_bytes(v, sh[k]) for k, v in batch.items())
        err = ef_init(model) if grad_compression else None
        if err is not None:
            arg += sum(_local_bytes(t) for t in err.values())
        if not run:
            return None, arg, 0
        step = make_train_step(cfg, mesh, microbatches=mb,
                               grad_compression=grad_compression)
        with OpCounter(base_bytes=arg) as counter:
            step(model, opt, batch, err)
        outputs = 0
    elif shape["kind"] == "prefill":
        batch = _fake_inputs(input_specs(cfg, shape))
        sh = batch_shardings(batch, mesh, b, all_axes=rwkv)
        arg += sum(_local_bytes(v, sh[k]) for k, v in batch.items())
        if not run:
            return None, arg, 0
        step = make_prefill_step(cfg, mesh)
        with OpCounter(base_bytes=arg) as counter:
            logits, caches = step(model, batch)
        outputs = _local_bytes(logits) + sum(
            _local_bytes(t) for c in caches for t in c.values())
    else:  # decode
        cache = init_cache(cfg, b, s, dtype=torch.bfloat16, device="cpu")
        csh = cache_shardings(cache, mesh, b)
        cache = [{k: sh[k].distribute(t) for k, t in c.items()}
                 for c, sh in zip(cache, csh)]
        arg += sum(_local_bytes(t) for c in cache for t in c.values())
        token = _fake_inputs(input_specs(cfg, shape))["token"]
        arg += _local_bytes(token, batch_shardings(token, mesh, b))
        if not run:
            return None, arg, 0
        step = make_decode_step(cfg, mesh)
        with OpCounter(base_bytes=arg) as counter:
            logits, cache = step(model, cache, token, s - 1)
        outputs = _local_bytes(logits)
    return counter, arg, outputs


def argument_bytes(cfg, shape_name: str, multi_pod: bool = False) -> int:
    """A cell's ``memory.argument_bytes`` without running its step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        with FakeTensorMode():
            return _trace(cfg, SHAPES[shape_name], mesh, {}, run=False)[1]


def run_cell(arch: str, shape_name: str, multi_pod: bool, hw: HW = HW(),
             cfg=None, grad_compression: bool = False) -> dict:
    """One cell's record.  ``cfg`` overrides the registered config (tests
    trace reduced ones); ``grad_compression`` traces a train step with the
    int8 error feedback."""
    cfg = cfg or get(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped",
            "reason": "pure full-attention arch: 500k dense-KV decode is "
                      "out of scope per DESIGN.md §4",
        }
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s = shape["batch"], shape["seq"]
    extra = {}
    if grad_compression:
        if shape["kind"] != "train":
            raise ValueError(f"{shape_name} is not a train shape: int8 "
                             "gradient compression runs in training only")
        extra["grad_compression"] = "int8"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_dev = mesh.size()
        t0 = time.time()
        with FakeTensorMode():
            counter, arg, outputs = _trace(cfg, shape, mesh, extra,
                                           grad_compression=grad_compression)
        trace_s = time.time() - t0
    stats = counter.stats

    n_active = cfg.active_param_count()
    if shape["kind"] == "train":
        model_flops = 6.0 * n_active * b * s
    elif shape["kind"] == "prefill":
        model_flops = 2.0 * n_active * b * s
    else:
        model_flops = 2.0 * n_active * b
    terms = roofline_terms(stats.flops, stats.hbm_bytes, stats.wire_bytes, hw)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_devices": n_dev,
        "family": cfg.family,
        "params": cfg.param_count(),
        "active_params": n_active,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg,
            "output_bytes": outputs,
            "peak_bytes": stats.peak_bytes,
        },
        "op_stats": {
            "flops_per_device": stats.flops,
            "hbm_bytes_per_device": stats.hbm_bytes,
            "wire_bytes_per_device": stats.wire_bytes,
            "n_ops": stats.n_ops,
            "collectives": [
                {"kind": c.kind, "payload_bytes": c.result_bytes,
                 "group": c.group_size, "count": c.count}
                for c in sorted(stats.collective_ops(),
                                key=lambda c: -c.wire_bytes() * c.count)[:20]
            ],
        },
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flops_ratio": (model_flops / n_dev) / max(stats.flops, 1.0),
        "roofline": terms,
        **extra,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    args = ap.parse_args(argv)
    int8 = args.grad_compression == "int8"

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = names() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    if int8:
        shapes = [s for s in shapes if SHAPES[s]["kind"] == "train"]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    fan_out = args.all or args.both_meshes or len(archs) > 1 or len(shapes) > 1

    failures = 0
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
                tag = "__int8" if int8 else ""
                path = out / f"{arch}__{shape}__{mesh_name}{tag}.json"
                if path.exists() and not args.force:
                    print(f"[skip-existing] {path.name}")
                    continue
                print(f"=== {arch} x {shape} x {mesh_name} ===", flush=True)
                if fan_out:
                    # one subprocess per cell: one fake group each, and a
                    # single failure does not sink the whole matrix
                    cmd = [
                        sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--out", str(out),
                    ]
                    if multi_pod:
                        cmd.append("--multi-pod")
                    if args.force:
                        cmd.append("--force")
                    if int8:
                        cmd += ["--grad-compression", "int8"]
                    rc = subprocess.run(cmd).returncode
                    if rc != 0:
                        failures += 1
                    continue
                try:
                    res = run_cell(arch, shape, multi_pod,
                                   grad_compression=int8)
                except Exception:
                    failures += 1
                    res = {
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "error",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(res["traceback"], flush=True)
                path.write_text(json.dumps(res, indent=1))
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(
                        f"  ok: trace={res['trace_s']}s "
                        f"args={res['memory']['argument_bytes'] / 1e9:.3f}GB "
                        f"peak={res['memory']['peak_bytes'] / 1e9:.3f}GB "
                        f"compute={r['compute_s']:.4f}s "
                        f"memory={r['memory_s']:.4f}s "
                        f"collective={r['collective_s']:.4f}s "
                        f"-> {r['dominant']}",
                        flush=True,
                    )
    print(f"done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
