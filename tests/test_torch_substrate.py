"""The port's training substrate against the reference's: the data
pipeline, checkpoints, the fault-tolerant loop, straggler tracking and
elastic mesh planning (``repro_torch.data``, ``.checkpoint``,
``.runtime``), on the CPU.

- ``SyntheticLM``, ``MemmapTokens`` and ``make_batches`` give the
  reference's batches bit for bit (the same numpy Philox stream);
- a checkpoint saved by either package loads in the other, every array
  bit for bit (float32, int32, int64, bool, 0-d, bfloat16); the port's
  MessagePack codec gives ``msgpack.packb(..., use_bin_type=True)``'s bytes
  and reads them back; the manifests are equal;
- the reference's loop, straggler and elastic tests, mirrored on the port;
- the loop over a reduced LM: a crash at step 15 with checkpoints every 5
  steps ends bit for bit where an uninterrupted run ends, and a NaN batch
  under ``nan_policy="skip"`` leaves the state bit for bit as it was.
"""

import dataclasses
import json

import msgpack
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint.manager import load_pytree as ref_load_pytree
from repro.checkpoint.manager import save_pytree as ref_save_pytree
from repro.data.pipeline import MemmapTokens as RefMemmapTokens
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import make_batches as ref_make_batches
from repro.runtime.elastic import plan_mesh as ref_plan_mesh
from repro.runtime.elastic import replan as ref_replan
from repro_torch import configs
from repro_torch.checkpoint import codec
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from repro_torch.data.pipeline import (
    MemmapTokens,
    Prefetcher,
    SyntheticLM,
    make_batches,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import OptState, adamw_init, ef_init
from repro_torch.runtime.elastic import plan_mesh, replan
from repro_torch.runtime.fault import FaultConfig, ResilientLoop, StragglerTracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (1000, 16, 8, 1, 2), (50257, 128, 8, 0, 1), (97, 5, 6, 12345, 3)])
def test_synthetic_lm_equals_the_reference(vocab, seq, batch, seed, hosts):
    for host in range(hosts):
        ours = SyntheticLM(vocab, seq, batch, seed, host, hosts)
        ref = RefSyntheticLM(vocab, seq, batch, seed, host, hosts)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_memmap_tokens_and_make_batches_equal_the_reference(tmp_path):
    data = np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16)
    path = tmp_path / "toks.bin"
    data.tofile(path)
    for host in range(2):
        ours = MemmapTokens(str(path), 10, 4, host_id=host, n_hosts=2)
        ref = RefMemmapTokens(str(path), 10, 4, host_id=host, n_hosts=2)
        for step in (0, 3, 500):
            np.testing.assert_array_equal(ours.batch_at(step)["tokens"],
                                          ref.batch_at(step)["tokens"])
    ours = make_batches(300, 12, 4, seed=3, start_step=5)
    ref = ref_make_batches(300, 12, 4, seed=3, start_step=5)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(ours)["tokens"],
                                          next(ref)["tokens"])
    finally:
        ours.close()
        ref.close()


def test_synthetic_deterministic_and_host_sharded():
    """The reference's test, on the port."""
    a = SyntheticLM(1000, 16, 8, seed=1, host_id=0, n_hosts=2)
    b = SyntheticLM(1000, 16, 8, seed=1, host_id=0, n_hosts=2)
    c = SyntheticLM(1000, 16, 8, seed=1, host_id=1, n_hosts=2)
    ba, bb, bc = a.batch_at(7), b.batch_at(7), c.batch_at(7)
    assert np.array_equal(ba["tokens"], bb["tokens"])
    assert not np.array_equal(ba["tokens"], bc["tokens"])
    assert ba["tokens"].shape == (4, 17)
    assert ba["tokens"].max() < 1000 and ba["tokens"].min() >= 0


def test_prefetcher_yields_in_order():
    """The reference's test, on the port."""
    src = SyntheticLM(100, 8, 2, seed=0)
    pf = Prefetcher(iter(src), depth=2)
    got = next(pf)["tokens"]
    assert np.array_equal(src.batch_at(0)["tokens"], got)
    pf.close()


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #


def _tree():
    rng = np.random.default_rng(0)
    return {
        "layers": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                   "b": rng.standard_normal(8).astype(np.float32)},
        "step": np.int32(7),
        "ids": rng.integers(0, 9, (3, 2)).astype(np.int64),
        "mask": rng.integers(0, 2, 5).astype(bool),
        "list": [np.float32(1.5), np.arange(3, dtype=np.int32)],
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_load(writer, tmp_path):
    tree = _tree()
    save = ref_save_pytree if writer == "reference" else save_pytree
    save(tree, tmp_path / "ck", extra={"note": "x", "step": 3})
    for load in (ref_load_pytree, load_pytree):
        flat, extra = load(tmp_path / "ck")
        assert extra == {"note": "x", "step": 3}
        want = _flat(tree)
        assert sorted(flat) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(flat[k]), v)
            assert np.asarray(flat[k]).dtype == v.dtype
        loaded, _ = load(tmp_path / "ck", target=tree)
        for k, v in _flat(loaded).items():
            np.testing.assert_array_equal(v, want[k])


def test_the_two_packages_write_the_same_files(tmp_path):
    tree = _tree()
    ref_save_pytree(tree, tmp_path / "a", extra={"step": 1})
    save_pytree(tree, tmp_path / "b", extra={"step": 1})
    assert (sorted(p.name for p in (tmp_path / "a").iterdir())
            == sorted(p.name for p in (tmp_path / "b").iterdir()))
    assert ((tmp_path / "a" / "manifest.json").read_text()
            == (tmp_path / "b" / "manifest.json").read_text())
    for blob in (tmp_path / "a").glob("arrays.*"):
        assert blob.read_bytes() == (tmp_path / "b" / blob.name).read_bytes()


def test_bfloat16_tensors_cross_load(tmp_path):
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    save_pytree({"w": t}, tmp_path / "port")
    ref, _ = ref_load_pytree(tmp_path / "port")
    assert str(ref["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(ref["w"], np.float32),
                                  t.float().numpy())
    ref_save_pytree({"w": jnp.asarray(t.float().numpy(), jnp.bfloat16)},
                    tmp_path / "ref")
    back, _ = load_pytree(tmp_path / "ref", target={"w": t})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    raw, _ = load_pytree(tmp_path / "ref")
    assert torch.equal(raw["w"], t)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 300])
def test_codec_bytes_equal_msgpack(n):
    rng = np.random.default_rng(n)
    sizes = [0, 1, 31, 32, 255, 256, 65535, 65536, 70000]
    m = {("k" * (i % 40)) + f"/{i}" + ("x" * (300 if i == 3 else 0)):
         rng.integers(0, 256, sizes[i % len(sizes)]).astype(np.uint8).tobytes()
         for i in range(n)}
    raw = codec.packb(m)
    assert raw == msgpack.packb(m, use_bin_type=True)
    assert codec.unpackb(raw) == m == msgpack.unpackb(raw, raw=False)


def test_codec_refuses_other_types():
    with pytest.raises(TypeError):
        codec.packb({"a": 1})
    with pytest.raises(ValueError, match="unsupported"):
        codec.unpackb(msgpack.packb({"a": 1}))


def test_load_puts_arrays_on_the_target_leaf_device_and_dtype(tmp_path):
    p = torch.nn.Parameter(torch.randn(4, 3))
    opt = OptState(torch.tensor(2, dtype=torch.int32),
                   {"x": torch.ones(3)}, {"x": torch.zeros(3)})
    tree = {"params": {"blocks.0.w": p}, "opt": opt, "n": np.int64(3)}
    save_pytree(tree, tmp_path / "ck")
    flat, _ = load_pytree(tmp_path / "ck")
    assert sorted(flat) == ["n", "opt/mu/x", "opt/nu/x", "opt/step",
                            "params/blocks.0.w"]
    target = {"params": {"blocks.0.w": torch.nn.Parameter(
        torch.zeros(4, 3, dtype=torch.float64))}, "opt": opt, "n": 0}
    back, _ = load_pytree(tmp_path / "ck", target=target)
    w = back["params"]["blocks.0.w"]
    assert isinstance(w, torch.nn.Parameter) and w.requires_grad
    assert w.dtype == torch.float64 and torch.equal(w.float(), p.detach())
    assert isinstance(back["opt"], OptState)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 2
    assert back["n"] == 3


def test_checkpoint_roundtrip(tmp_path):
    """The reference's test, on the port."""
    tree = {"layers": {"w": np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32)}, "step": np.int32(7)}
    save_pytree(tree, tmp_path / "ck", extra={"note": "x"})
    loaded, extra = load_pytree(tmp_path / "ck", target=tree)
    np.testing.assert_array_equal(loaded["layers"]["w"], tree["layers"]["w"])
    assert extra["note"] == "x"


def test_checkpoint_manager_retention_and_latest(tmp_path):
    """The reference's test, on the port: the atomic rename leaves no
    ``.tmp`` directory, and ``keep`` bounds retention."""
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"w": torch.full((3,), float(s))}, blocking=True)
    assert mgr.steps() == [20, 30]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030"]
    tree, extra = mgr.restore_latest(target={"w": torch.zeros(3)})
    assert extra["step"] == 30
    assert float(tree["w"][0]) == 30


def test_saves_copy_tensors_that_are_updated_in_place(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)  # while the background job may still be writing
    mgr.wait()
    tree, _ = mgr.restore_latest(target={"w": w})
    assert torch.all(tree["w"] == 0.0)


# --------------------------------------------------------------------------- #
# fault-tolerant loop, stragglers, elastic plans (the reference's tests)
# --------------------------------------------------------------------------- #


def _toy_step(state, batch):
    new = {"w": state["w"] + batch["x"].sum()}
    return new, {"loss": float(torch.abs(new["w"]))}


def test_resilient_loop_recovers_from_chaos(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    crashes = {15}

    def chaos(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError("simulated preemption")

    loop = ResilientLoop(_toy_step, {"w": torch.zeros(())}, mgr,
                         lambda s: {"x": torch.ones(2)},
                         FaultConfig(checkpoint_every=5, max_retries=2),
                         chaos=chaos)
    rep = loop.run(30)
    assert rep.restores == 1
    assert float(loop.state["w"]) == pytest.approx(60.0)


def test_resilient_loop_skips_nan(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            return state, {"loss": float("nan")}
        return {"w": state["w"] + 1}, {"loss": 1.0}

    loop = ResilientLoop(step, {"w": torch.zeros(())}, mgr, lambda s: {},
                         FaultConfig(checkpoint_every=100, nan_policy="skip"))
    rep = loop.run(10)
    assert rep.skipped_nan == 1
    assert float(loop.state["w"]) == 9.0


def test_straggler_tracker_flags_slow_host():
    tr = StragglerTracker(4, threshold=2.0)
    for _ in range(10):
        slow = tr.update(np.array([1.0, 1.0, 1.0, 5.0]))
    assert slow == [3]


@pytest.mark.parametrize("n,mp,per_pod", [(512, 16, 256), (256, 16, 256),
                                          (8, 16, 256), (1000, 8, 128),
                                          (3, 4, 4)])
def test_plan_mesh_equals_the_reference(n, mp, per_pod):
    got, want = plan_mesh(n, mp, per_pod), ref_plan_mesh(n, mp, per_pod)
    assert (got.shape, got.axis_names) == (want.shape, want.axis_names)
    for new_n in (n // 2 or 1, n + 256):
        g, gr = replan(got, new_n)
        w, wr = ref_replan(want, new_n)
        assert (g.shape, g.axis_names, gr) == (w.shape, w.axis_names, wr)


def test_replan_preserves_model_parallel():
    old = plan_mesh(512, 16, 256)
    new, rep = replan(old, 768)
    assert rep["model_parallel_preserved"]
    assert new.n_devices <= 768


def test_straggler_triggers_elastic_replan(tmp_path):
    """The fault story end to end on the port's fabric: a persistent
    straggler is flagged, evicted from the fabric, and the mesh replanned."""
    from repro_torch.fabric import make_fabric

    mgr = CheckpointManager(tmp_path, keep=2)
    fabric = make_fabric("jellyfish", n_pods=8, degree=4, seed=0,
                         device="cpu")
    state = {"fabric": fabric, "mesh": plan_mesh(8 * 4, model_parallel=4,
                                                 devices_per_pod=4),
             "evicted": []}

    def on_straggler(slow_hosts):
        for h in slow_hosts:
            if h in state["evicted"]:
                continue
            state["evicted"].append(h)
            state["fabric"] = state["fabric"].remove(h, seed=1)
            n_pods = state["fabric"].topology.n_switches
            state["mesh"], report = replan(state["mesh"], n_pods * 4)
            assert report["model_parallel_preserved"]

    times = np.ones(8)
    times[5] = 9.0
    loop = ResilientLoop(_toy_step, {"w": torch.zeros(())}, mgr,
                         lambda s: {"x": torch.ones(1)},
                         FaultConfig(checkpoint_every=100,
                                     straggler_threshold=2.0),
                         host_times=lambda step: times,
                         on_straggler=on_straggler)
    rep = loop.run(12)
    assert state["evicted"] == [5]
    assert state["fabric"].topology.n_switches == 7
    assert state["fabric"].ring().congestion >= 1
    assert rep.steps_done == 12


# --------------------------------------------------------------------------- #
# the loop over a reduced LM
# --------------------------------------------------------------------------- #


def _lm_loop(arch, root, n_steps, chaos=None, nan_at=(), compress=False):
    """``launch.train``'s loop, reduced in float32 on the CPU, at 5-step
    checkpoints; batches carrying a NaN input embedding at ``nan_at``."""
    from repro_torch.launch.train import _bind

    cfg = configs.get(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    step_fn = make_train_step(cfg, lr=1e-3, grad_compression=compress,
                              dtype=torch.float32)
    state = {"params": dict(model.named_parameters()),
             "opt": adamw_init(model)}
    if compress:
        state["ef"] = ef_init(model)

    def run_step(state, batch):
        _bind(model, state["params"])
        out = step_fn(model, state["opt"], batch, state.get("ef"))
        new = {"params": dict(model.named_parameters()), "opt": out[1]}
        if compress:
            new["ef"] = out[3]
        return new, out[2]

    def batch_at(step):
        g = torch.Generator().manual_seed(step)
        emb = torch.randn((2, 4, cfg.d_model), generator=g) * 0.02
        if step in nan_at:
            emb[0, 1, 2] = float("nan")
        return {"inputs_embeds": emb,
                "tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                        generator=g)}

    loop = ResilientLoop(run_step, state, CheckpointManager(root, keep=2),
                         batch_at, FaultConfig(checkpoint_every=5,
                                               max_retries=2),
                         chaos=chaos)
    rep = loop.run(n_steps)
    _bind(model, loop.state["params"])
    return model, loop.state, rep


def _state_tensors(model, state) -> list:
    opt = state["opt"]
    return [t.detach().clone() for t in (
        *model.parameters(), opt.step, *opt.mu.values(), *opt.nu.values(),
        *state.get("ef", {}).values())]


@pytest.mark.parametrize("compress", [False, True])
def test_lm_loop_recovers_from_a_crash_bit_for_bit(compress, tmp_path):
    crashes = {15}

    def chaos(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError("simulated preemption")

    model, state, rep = _lm_loop("internvl2-1b", tmp_path / "a", 20, chaos,
                                 compress=compress)
    assert rep.restores == 1 and rep.steps_done == 20
    ref_model, ref_state, ref_rep = _lm_loop("internvl2-1b", tmp_path / "b",
                                             20, compress=compress)
    assert ref_rep.restores == 0
    assert rep.losses[-5:] == ref_rep.losses[-5:]
    a, b = _state_tensors(model, state), _state_tensors(ref_model, ref_state)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(state["opt"].step) == 20


def test_lm_loop_skips_a_nan_batch_bit_for_bit(tmp_path):
    """Step 3's batch carries a NaN: the loop drops it, and the state after
    3 steps (batches 0-2) and after 4 (batches 0-3, 3 dropped) is the same,
    bit for bit; the run then goes on from it."""
    m3, s3, _ = _lm_loop("internvl2-1b", tmp_path / "a", 3)
    m4, s4, rep = _lm_loop("internvl2-1b", tmp_path / "b", 4, nan_at={3})
    assert rep.skipped_nan == 1 and len(rep.losses) == 3
    a, b = _state_tensors(m3, s3), _state_tensors(m4, s4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(s4["opt"].step) == 3
    m6, s6, rep6 = _lm_loop("internvl2-1b", tmp_path / "c", 6, nan_at={3})
    assert rep6.skipped_nan == 1 and int(s6["opt"].step) == 5
    assert all(np.isfinite(rep6.losses))


def test_loop_state_restores_as_the_trainer_binds_it(tmp_path):
    """After a restore the loop's state holds new parameter tensors; the
    trainer copies them into the model (``launch.train._bind``)."""
    from repro_torch.launch.train import _bind

    model = init_params(configs.get("rwkv6-1.6b").reduced(), seed=0,
                        device="cpu")
    state = {"params": dict(model.named_parameters()),
             "opt": adamw_init(model)}
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(5, state, blocking=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    restored, extra = mgr.restore_latest(target=state)
    assert extra["step"] == 5
    assert all(restored["params"][n] is not p
               for n, p in model.named_parameters())
    _bind(model, restored["params"])
    for n, p in model.named_parameters():
        assert torch.equal(p, restored["params"][n])
    assert dataclasses.is_dataclass(restored["opt"])
    assert json.loads((mgr.dir_for(5) / "manifest.json").read_text())[
        "extra"] == {"step": 5}
