"""The port's examples (``examples/*_torch.py``) on the CPU.

``expand_cluster_torch`` and ``quickstart_torch`` run and are held against
the same chains run through ``repro`` (the reference examples' steps, with
their checkpoint under ``tmp_path``):

* exact: every topology and fabric description, path statistics, each
  path system (its tables, by digest), the share of path rows spliced by
  each delta, the re-embedded ring, the mesh plans and re-plans, the
  restored checkpoint;
* LP alphas (host scipy / HiGHS on equal path systems): rtol 1e-9;
* MW alphas: rtol 5e-3, MW's stated tolerance over a few hundred
  iterations (``tests/test_torch_flow.py``);
* fluid MPTCP's mean throughput and Jain index: atol 2e-6
  (``tests/test_torch_mptcp.py``).

``serve_lm_torch`` and ``train_lm_torch`` smoke-run at their reduced and
``--tiny`` sizes (the port's weights come from ``torch.Generator``, so
there is no reference draw to hold them against).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
from repro.checkpoint.manager import CheckpointManager as RefCheckpoints
from repro.fabric import make_fabric as ref_make_fabric
from repro.runtime.elastic import plan_mesh as ref_plan_mesh
from repro.runtime.elastic import replan as ref_replan

ROOT = pathlib.Path(__file__).resolve().parents[1]
MW_RTOL = 5e-3
LP_RTOL = 1e-9
MPTCP_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spliced(ps) -> float:
    return float((ps.row_map >= 0).mean()) if ps.row_map is not None else 0.0


def _reference_expand_chain(ckpt_dir, digest) -> dict:
    """``examples/expand_cluster.py``'s steps through ``repro``, readings
    in ``expand_cluster_torch.main()``'s layout."""
    out = {"routing": []}
    fabric = ref_make_fabric("jellyfish", n_pods=64, degree=6, seed=0)
    mesh = ref_plan_mesh(64 * 256, model_parallel=16, devices_per_pod=256)
    out["describe"] = [fabric.describe()]
    out["mesh"] = mesh.describe()

    def route(comm, warm=None):
        ps = fabric.path_system(comm)
        flow = R.mw_concurrent_flow(ps, iters=200, warm=warm)
        out["routing"].append({
            "switches": fabric.topology.n_switches, "n_paths": ps.n_paths,
            "digest": digest(ps), "alpha": flow.alpha,
            "spliced": _spliced(ps)})
        return flow

    perm = R.random_server_permutation(fabric.topology.n_servers, seed=0)
    comm = R.permutation_commodities(fabric.topology, perm)
    flow = route(comm)
    ckpt = RefCheckpoints(str(ckpt_dir), keep=2)
    params = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    ckpt.save(100, params, extra={"mesh": mesh.describe()}, blocking=True)
    for tranche in range(4):
        fabric = fabric.expand(4, seed=10 + tranche)
        perm = R.extend_server_permutation(perm, fabric.topology.n_servers,
                                           seed=10 + tranche)
        comm = R.permutation_commodities(fabric.topology, perm)
        flow = route(comm, warm=flow)
    new_mesh, report = ref_replan(mesh, 80 * 256)
    out["describe"].append(fabric.describe())
    out["replan"] = [report]
    restored, extra = ckpt.restore_latest(target=params)
    out["restored"] = {"step": extra["step"],
                       "shape": tuple(restored["w"].shape),
                       "equal": bool(np.array_equal(restored["w"],
                                                    params["w"]))}
    fabric = fabric.fail(0.05, seed=3)
    route(comm, warm=flow)
    out["describe"].append(fabric.describe())
    fabric = fabric.remove(pod=3, seed=2)
    out["describe"].append(fabric.describe())
    out["ring"] = fabric.ring().summary()
    out["replan"].append(ref_replan(new_mesh, 79 * 256)[1])
    return out


def test_expand_cluster_equals_the_reference_chain(tmp_path):
    example = _example("expand_cluster_torch")
    got = example.main(
        ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "port")])
    want = _reference_expand_chain(tmp_path / "ref", example.system_digest)
    assert got["describe"] == want["describe"]
    assert got["mesh"] == want["mesh"]
    assert got["replan"] == want["replan"]
    assert got["ring"] == want["ring"]
    assert got["restored"] == want["restored"] == {
        "step": 100, "shape": (8, 8), "equal": True}
    assert len(got["routing"]) == len(want["routing"]) == 6
    for g, w in zip(got["routing"], want["routing"]):
        assert (g["switches"], g["n_paths"], g["digest"], g["spliced"]) == \
            (w["switches"], w["n_paths"], w["digest"], w["spliced"])
        assert g["alpha"] == pytest.approx(w["alpha"], rel=MW_RTOL)
    # the deltas really splice: every mutation reuses rows
    assert all(r["spliced"] > 0 for r in got["routing"][1:])


def _reference_quickstart() -> dict:
    """``examples/quickstart.py``'s steps through ``repro``."""

    def alpha(top, seed=0, k=8):
        comm = R.random_permutation_traffic(top, seed=seed)
        return R.lp_concurrent_flow(R.build_path_system(top, comm, k=k)).alpha

    out = {}
    ft = R.fattree(8)
    eq = R.fattree_equipment(8)
    out["fattree"] = (ft.describe(), str(R.path_stats(ft)))
    n_servers = int(eq["servers"] * 1.15)
    servers = np.full(eq["switches"], n_servers // eq["switches"])
    servers[: n_servers - servers.sum()] += 1
    jf = R.jellyfish_heterogeneous(np.full(eq["switches"], 8), servers, seed=0)
    out["jellyfish"] = (jf.describe(), str(R.path_stats(jf)))
    out["bollobas"] = R.bollobas_bound(8, 6)
    out["fattree_alpha"] = alpha(ft, k=32)
    out["jellyfish_alpha"] = alpha(jf)
    grown = R.expand_to(jf, jf.n_switches + 20, 8, 6, seed=1)
    out["expanded"] = grown.describe()
    out["grown_alpha"] = alpha(grown)
    out["failed_alpha"] = alpha(R.fail_links(jf, 0.09, seed=2))
    comm = R.random_permutation_traffic(jf, seed=3)
    mp = R.mptcp_throughput(R.build_path_system(jf, comm, k=8))
    out["mptcp"] = (mp.mean_throughput, mp.jain_index)
    return out


def test_quickstart_equals_the_reference_chain():
    got = _example("quickstart_torch").main(["--device", "cpu"])
    want = _reference_quickstart()
    assert set(got) == set(want)
    for key in ("fattree", "jellyfish", "expanded", "bollobas"):
        assert got[key] == want[key], key
    for key in ("fattree_alpha", "jellyfish_alpha", "grown_alpha",
                "failed_alpha"):
        assert got[key] == pytest.approx(want[key], rel=LP_RTOL), key
    np.testing.assert_allclose(got["mptcp"], want["mptcp"], rtol=0,
                               atol=MPTCP_ATOL)


def test_serve_example_smoke():
    got = _example("serve_lm_torch").main(["--device", "cpu"])
    assert set(got) == {"qwen2.5-32b", "mixtral-8x22b", "rwkv6-1.6b",
                        "recurrentgemma-2b"}
    assert {r["family"] for r in got.values()} == {
        "dense", "moe", "rwkv6", "rglru_hybrid"}
    for r in got.values():
        assert r["tokens"].shape == (4, 12)
        assert r["prefill_ms"] > 0 and r["decode_ms_per_token"] > 0


def test_train_example_tiny_smoke(tmp_path):
    rep = _example("train_lm_torch").main(
        ["--tiny", "--steps", "12", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path)])
    assert rep.steps_done == 12
    assert all(np.isfinite(rep.losses))
    assert rep.losses[-1] < rep.losses[0]
