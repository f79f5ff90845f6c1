"""The port's dispatch-level auditor (``repro_torch.analysis.irlint``, rules
JF100-JF105), its registry and its compile tracer, on the CPU.

The port of ``tests/test_irlint.py`` and of the retrace tests of
``tests/test_analysis.py`` and ``tests/test_obs.py``, in five groups:

* rule fixtures: every JF10x rule fires on a minimal bad fixture and stays
  silent on the corrected twin; a completeness check pins the fixture set
  to ``IR_RULES``;
* HEAD: the tree audits clean, including the checked-in footprint budget
  (``artifacts/ir_budget_torch.json``), through the CLI;
* regressions: replacing ``_fold_sum`` by ``torch.sum``, or
  ``_ordered_fan_in_sum`` by a ``scatter_add``, is caught;
* the mapping: every entry the reference registers maps to a registered
  port entry, or records why the port folded it;
* RT-1: a second same-bucket batched solve builds no kernel and leaves
  ``solver_cache_sizes()`` unchanged; a bus-published build is counted.

The cases run on the CPU, where the kernels' plain versions run and no
launch counter moves; ``tests/test_torch_cuda.py`` runs the audit on a
card.  This file imports the reference's registry only (stdlib plus the
reference's solver modules); its IR auditor fails at import under the
installed JAX, and nothing here depends on it.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels, obs
from repro_torch.analysis import irlint, registry, retrace
from repro_torch.analysis.irlint import (
    audit_case,
    audit_fold_tree,
    check_reference_map,
    check_registration,
    compare_budget,
    measure_case,
    trace_case,
    trace_fn,
)
from repro_torch.analysis.registry import (
    IR_RULES,
    REFERENCE_ENTRIES,
    AuditCase,
    SolverEntry,
    registered_entries,
    solver_entry,
)
from repro_torch.core import (
    build_path_system,
    flow,
    jellyfish,
    mw_concurrent_flow_batch,
    random_permutation_traffic,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = str(ROOT / "src" / "repro_torch")
BUDGET = ROOT / "artifacts" / "ir_budget_torch.json"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _audit_fn(fn, *args, backend=None, exempt=None, kind="solver"):
    """Run the per-case rules on a bare function (toy-fixture harness)."""
    entry = SolverEntry(module="toy", attr=getattr(fn, "__name__", "fn"),
                        kind=kind)
    case = AuditCase(label="t", make=lambda dev: (args, {}), backend=backend,
                     exempt=exempt or {})
    return audit_case(entry, case, trace_fn(fn, *args))


def _rules(findings):
    return sorted({f.rule for f in findings})


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #


def test_registry_enumerates_every_solver_entry():
    entries = registered_entries()
    for name in ("repro_torch.core.flow._mw_steps",
                 "repro_torch.core.flow._mw_final",
                 "repro_torch.core.mptcp._pf_solve",
                 "repro_torch.sim.engine._waterfill_core",
                 "repro_torch.sim.engine._run_steps",
                 "repro_torch.kernels.admission.admission",
                 "repro_torch.kernels.minplus.minplus_hops",
                 "repro_torch.kernels.ops.minplus",
                 "repro_torch.kernels.ops.matmul"):
        assert name in entries
    assert all(e.kind in ("solver", "wrapper") for e in entries.values())
    counters = set(kernels.launch_counts())
    for e in entries.values():
        assert e.module in registry.SOLVER_MODULES
        cases = e.cases()
        assert cases, e.name
        for c in cases:
            assert set(c.kernels) <= counters, (e.name, c.label)
            assert all(reason.strip() for reason in c.exempt.values())
    # wrappers join the audit but not the solver view of RT-1
    solvers = retrace.named_solver_entries()
    assert "repro_torch.kernels.ops.congestion" in entries
    assert "repro_torch.kernels.ops.congestion" not in solvers
    assert "repro_torch.kernels.congestion.congestion" in solvers
    assert all(callable(fn) for fn in solvers.values())


def test_solver_entry_rejects_bad_kind():
    with pytest.raises(ValueError, match="kind"):
        solver_entry(kind="jit")


def test_every_kernel_and_dense_case_names_its_launch_counter():
    """On a card the launch counters are the only evidence a case reached
    its kernel: every kernel entry's case, every dense solver case and
    every gather case of the simulator (its loads-only product is the
    fan-in kernel) names the counter it must move."""
    for name, e in registered_entries().items():
        for c in e.cases():
            kernel_entry = ".kernels." in name and not name.endswith("_ref")
            if name.startswith("repro_torch.sim.") and c.backend == "gather":
                assert c.kernels == ("fan_in_loads",), (name, c.label)
            elif kernel_entry or c.backend == "dense":
                assert c.kernels, (name, c.label)
            else:
                assert not c.kernels, (name, c.label)


def test_reference_entries_map_every_reference_registration():
    from repro.analysis.registry import registered_entries as ref_entries

    assert set(REFERENCE_ENTRIES) == set(ref_entries())
    assert len(REFERENCE_ENTRIES) == 19
    for ref, port in REFERENCE_ENTRIES.items():
        if port is None:
            assert registry.FOLDED_REASONS[ref].strip()
    assert check_reference_map() == []


def test_reference_map_fires_on_a_missing_target(monkeypatch):
    monkeypatch.setitem(REFERENCE_ENTRIES, "repro.core.flow._mw_final",
                        "repro_torch.core.flow._no_such_entry")
    monkeypatch.setitem(REFERENCE_ENTRIES, "repro.core.flow._mw_carry_init",
                        None)
    monkeypatch.delitem(registry.FOLDED_REASONS,
                        "repro.core.flow._mw_carry_init")
    fired = check_reference_map()
    assert [f.rule for f in fired] == ["JF100", "JF100"]


# --------------------------------------------------------------------------- #
# rule fixtures: fire + silent per rule
# --------------------------------------------------------------------------- #


def test_jf101_fires_on_float_sum_method_and_matmul():
    x = torch.linspace(0.5, 1.5, 5)
    fired = _audit_fn(lambda v: v.sum(), x)
    assert _rules(fired) == ["JF101"]
    assert "_fold_sum" in fired[0].message
    a = torch.rand((4, 4), generator=torch.Generator().manual_seed(0))
    assert _rules(_audit_fn(lambda u, v: u @ v, a, a)) == ["JF101"]
    assert _rules(_audit_fn(lambda v: torch.softmax(v, 0), x)) == ["JF101"]


def test_jf101_silent_on_fold_sum_int_sum_max_and_exemption():
    x = torch.linspace(0.5, 1.5, 5)
    assert _audit_fn(flow._fold_sum, x) == []
    # integer and bool reductions are exactly associative
    assert _audit_fn(lambda v: v.sum(), torch.arange(5, dtype=torch.int32)) \
        == []
    assert _audit_fn(lambda v: (v > 1.0).sum(), x) == []
    assert _audit_fn(lambda v: v.amax(dim=-1), x) == []
    a = torch.rand((4, 4), generator=torch.Generator().manual_seed(0))
    assert _audit_fn(lambda u, v: u @ v, a, a,
                     exempt={"JF101": "dense by design"}) == []


@pytest.mark.parametrize("kind", ["scatter_add", "index_add", "index_put",
                                  "scatter_reduce_sum"])
def test_jf102_fires_on_accumulating_scatter_under_gather(kind):
    vals = torch.linspace(0.5, 1.5, 4)
    idx = torch.tensor([0, 2, 2, 5])

    def scat(x, i):
        acc = torch.zeros(8)
        if kind == "scatter_add":
            return acc.scatter_add(0, i, x)
        if kind == "index_add":
            return acc.index_add(0, i, x)
        if kind == "index_put":
            return acc.index_put((i,), x, accumulate=True)
        return acc.scatter_reduce(0, i, x, reduce="sum")

    assert _rules(_audit_fn(scat, vals, idx, backend="gather")) == ["JF102"]
    # the same program under the dense backend is outside the rule
    assert _audit_fn(scat, vals, idx, backend="dense") == []


def test_jf102_silent_on_ordered_fan_in_and_amin_scatter():
    fr = torch.linspace(0.5, 1.5, 10)
    table = [torch.tensor([0, 3, 9]), torch.tensor([1, 9, 9])]
    assert _audit_fn(flow._ordered_fan_in_sum, fr, table,
                     backend="gather") == []
    # a min is exact in any order (the MPTCP response's per-commodity min)
    inf = torch.full((3,), float("inf"))
    assert _audit_fn(lambda q, o: inf.scatter_reduce(0, o, q, reduce="amin"),
                     fr[:4], torch.tensor([0, 0, 1, 2]),
                     backend="gather") == []


def test_jf103_fires_on_float64_and_passes_int64_indices():
    x = torch.linspace(0.5, 1.5, 3)
    fired = _audit_fn(lambda v: v.double() * 2.0, x)
    assert fired and _rules(fired) == ["JF103"]
    assert _rules(_audit_fn(lambda v: v * 2.0,
                            torch.ones(3, dtype=torch.float64))) == ["JF103"]
    # int64 is torch's index type: a stated divergence from the reference
    assert _audit_fn(lambda v: v[torch.arange(3)] * 2.0, x) == []


def test_jf104_fires_on_host_reads_in_a_solver_loop():
    x = torch.linspace(0.5, 1.5, 3)

    def item_in_loop(v):
        for _ in range(2):
            if v.max().item() > 0.0:
                v = v * 0.5
        return v

    fired = _audit_fn(item_in_loop, x)
    assert _rules(fired) == ["JF104"] and len(fired) == 2
    assert _rules(_audit_fn(lambda v: v[v > 1.0], x)) == ["JF104"]
    assert _rules(_audit_fn(lambda v: torch.nonzero(v), x)) == ["JF104"]
    assert _rules(_audit_fn(lambda v: v.repeat_interleave(
        torch.tensor([1, 2, 1])), x)) == ["JF104"]

    def masked(v):  # the sanctioned select-masked twin
        for _ in range(2):
            v = torch.where(v.amax() > 0.0, v * 0.5, v)
        return v

    assert _audit_fn(masked, x) == []
    # int repeats need no host read; wrappers are outside the rule
    assert _audit_fn(lambda v: v.repeat_interleave(3), x) == []
    assert _audit_fn(item_in_loop, x, kind="wrapper") == []


def test_jf104_sees_a_device_to_host_copy():
    rec = irlint.OpRecord(
        name="_to_copy.default", packet="_to_copy",
        in_dtypes=(torch.float32,), in_shapes=((3,),), in_devices=("cuda",),
        out_dtypes=(torch.float32,), out_shapes=((3,),),
        out_devices=("cpu",))
    trace = irlint.CaseTrace([rec], {}, None)
    entry = SolverEntry(module="toy", attr="f")
    case = AuditCase(label="t", make=lambda dev: ((), {}))
    assert _rules(audit_case(entry, case, trace)) == ["JF104"]
    up = dataclasses.replace(rec, in_devices=("cpu",), out_devices=("cuda",))
    assert audit_case(entry, case, irlint.CaseTrace([up], {}, None)) == []


def test_jf100_fires_on_an_unregistered_kernel_caller(tmp_path):
    d = tmp_path / "repro_torch" / "core"
    d.mkdir(parents=True)
    f = d / "newsolver.py"
    f.write_text("from ..kernels import ops\n\n\ndef step(b, r, w):\n"
                 "    return ops.congestion(b, r, w)\n")
    fired = check_registration([str(tmp_path)], entries=registered_entries())
    assert [x.rule for x in fired] == ["JF100"]
    assert "SOLVER_MODULES" in fired[0].message  # module itself unlisted

    # a listed module whose kernel caller is not registered
    d2 = tmp_path / "repro_torch" / "kernels"
    d2.mkdir(parents=True)
    (d2 / "minplus.py").write_text(
        "def rogue(a):\n    return minplus_hops(a, a)\n\n\n"
        "def loop(fused, x):\n    return fused(x, x)\n")
    fired = check_registration([str(d2)], entries=registered_entries())
    assert [x.rule for x in fired] == ["JF100", "JF100"]
    assert all("@solver_entry" in x.message for x in fired)

    # the pragma on the def line, with its reason, exempts it
    f.write_text("from ..kernels import ops\n\n\n"
                 "def step(b, r, w):  # repro-lint: disable=JF100 host loop\n"
                 "    return ops.congestion(b, r, w)\n")
    assert check_registration([str(f)], entries=registered_entries()) == []


def test_jf105_compare_budget_semantics():
    base = {"aten_ops": 100, "flops": 0.0, "hbm_bytes": 1000.0}
    budget = {"tolerance": {"rel": 0.25, "abs": {"aten_ops": 16}},
              "entries": {"m.f[x]": dict(base)}}

    # within tolerance (growth under rel+abs headroom): silent
    grown_ok = dict(base, aten_ops=int(100 * 1.25) + 16)
    findings, diff = compare_budget({"m.f[x]": grown_ok}, budget)
    assert findings == [] and diff["ok"]

    # beyond tolerance: fires with the limit in the message
    grown_bad = dict(base, aten_ops=int(100 * 1.25) + 17)
    findings, diff = compare_budget({"m.f[x]": grown_bad}, budget)
    assert [f.rule for f in findings] == ["JF105"]
    assert not diff["entries"]["m.f[x]"]["aten_ops"]["ok"]

    # shrinkage never fails
    findings, _ = compare_budget({"m.f[x]": dict(base, aten_ops=10)}, budget)
    assert findings == []

    # a measured case with no recorded budget fires
    findings, _ = compare_budget({"m.f[x]": base, "m.g[y]": base}, budget)
    assert [f.rule for f in findings] == ["JF105"]
    assert "no recorded" in findings[0].message

    # stale recorded cases fire only on a complete (unfiltered) audit
    findings, _ = compare_budget({}, budget, complete=True)
    assert [f.rule for f in findings] == ["JF105"]
    assert "stale" in findings[0].message
    findings, _ = compare_budget({}, budget, complete=False)
    assert findings == []


def test_jf105_measure_roundtrips_on_a_real_entry():
    entry = registered_entries()["repro_torch.kernels.power.matmul_ref"]
    m = measure_case(entry, entry.cases()[0])
    assert m["aten_ops"] >= 1 and m["flops"] == 2 * 40 * 8 * 40
    assert m["hbm_bytes"] > 0
    budget = {"tolerance": {"rel": 0.25, "abs": {}}, "entries": {"k[f32]": m}}
    findings, diff = compare_budget({"k[f32]": m}, budget)
    assert findings == [] and diff["ok"]


def test_every_ir_rule_has_fixtures():
    # each IR rule is exercised by a dedicated fire/silent test above (JF100
    # registration, JF101-JF104 dispatch rules, JF105 budget); keep this list
    # in lockstep with IR_RULES
    covered = {"JF100", "JF101", "JF102", "JF103", "JF104", "JF105"}
    assert covered == set(IR_RULES)


# --------------------------------------------------------------------------- #
# HEAD
# --------------------------------------------------------------------------- #


def test_head_audits_clean_through_the_cli(tmp_path):
    diff_out = tmp_path / "diff.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "ir", "--device",
         "cpu", "--diff-out", str(diff_out)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ir-audit: clean" in out.stdout
    assert json.loads(diff_out.read_text())["ok"]


def test_checked_in_budget_covers_every_budgeted_case():
    recorded = json.loads(BUDGET.read_text())
    budgeted = {
        f"{n}[{c.label}]" for n, e in registered_entries().items()
        for c in e.cases() if c.budget
    }
    assert set(recorded["entries"]) == budgeted
    assert recorded["torch"] and recorded["tolerance"]


def test_registration_and_fold_tree_clean_at_head():
    assert check_registration([PORT]) == []
    assert audit_fold_tree() == []


def test_cpu_cases_launch_no_kernel():
    entry = registered_entries()["repro_torch.core.flow._mw_steps"]
    case = next(c for c in entry.cases() if c.label == "seq-dense")
    trace = trace_case(entry, case, CPU)
    assert not any(trace.launches.values())
    assert audit_case(entry, case, trace) == []


def test_sim_case_records_the_ordered_scatter_add_host_reads():
    """The sim's exemptions are load-bearing: without them the case fires
    JF104 (``int(rank.max())`` in ``_ordered_scatter_add``, twice a step)
    and JF102 (its rounds and the exact tallies)."""
    entry = registered_entries()["repro_torch.sim.engine._run_steps"]
    case = next(c for c in entry.cases() if c.label == "ecmp-gather")
    trace = trace_case(entry, case, CPU)
    assert audit_case(entry, case, trace) == []
    bare = dataclasses.replace(case, exempt={})
    fired = audit_case(entry, bare, trace)
    reads = [f for f in fired if f.rule == "JF104"]
    assert len(reads) == 2 * 4  # two a step over the case's 4 steps
    assert all("_local_scalar_dense" in f.message for f in reads)
    assert _rules(fired) == ["JF102", "JF104"]


def test_fold_tree_sees_padding_slices_and_halving_adds():
    trace = trace_fn(flow._fold_sum, torch.linspace(0.5, 1.5, 5))
    packets = [r.packet for r in trace.records]
    assert packets[0] == "constant_pad_nd"
    adds = [r.out_shapes[0] for r in trace.records if r.packet == "add"]
    assert adds == [(4,), (2,), (1,)]


# --------------------------------------------------------------------------- #
# regressions: invariant breaks are caught
# --------------------------------------------------------------------------- #


def test_fold_sum_replaced_by_torch_sum_is_caught(monkeypatch):
    monkeypatch.setattr(flow, "_fold_sum", lambda x: torch.sum(x, dim=-1))
    # the structural tree check fires...
    tree = audit_fold_tree()
    assert tree and all(f.rule == "JF101" for f in tree)
    # ...and so does the MW loop body that routes its softmax through it
    entry = registered_entries()["repro_torch.core.flow._mw_steps"]
    case = next(c for c in entry.cases() if c.label == "seq-gather")
    assert "JF101" in _rules(audit_case(entry, case, device=CPU))


def test_gather_backend_scatter_regression_is_caught(monkeypatch):
    def corrupt(fr, table_cols):  # shape-correct stand-in that scatter-adds
        idx = table_cols[0]
        out_shape = fr.shape[:-1] + idx.shape[-1:]
        acc = torch.zeros(out_shape, dtype=fr.dtype)
        return acc.scatter_add(-1, torch.zeros_like(acc, dtype=torch.int64),
                               fr[..., : out_shape[-1]])

    monkeypatch.setattr(flow, "_ordered_fan_in_sum", corrupt)
    entry = registered_entries()["repro_torch.core.flow._mw_steps"]
    case = next(c for c in entry.cases() if c.label == "batch-gather")
    assert "JF102" in _rules(audit_case(entry, case, device=CPU))


# --------------------------------------------------------------------------- #
# RT-1: the compile tracer
# --------------------------------------------------------------------------- #


def test_track_compiles_counts_a_bus_published_build():
    with retrace.track_compiles() as c:
        obs.emit("cuda/nvcc_build", source="synthetic.cu", seconds=0.0)
        obs.emit("something/else")
    assert c.count == 1
    assert c.events == ["synthetic.cu"]
    obs.reset_metrics()


def test_solver_recompiles_nothing_within_a_bucket():
    def batch_of(seeds):
        out = []
        for s in seeds:
            top = jellyfish(22 + 2 * (s % 2), 8, 4, seed=s)
            comm = random_permutation_traffic(top, seed=s + 5)
            out.append(build_path_system(top, comm, k=4, device="cpu"))
        return out

    mw_concurrent_flow_batch(batch_of([0, 1]), iters=24, device="cpu")
    before = retrace.solver_cache_sizes()
    assert before and set(before.values()) == {-1}
    with retrace.track_compiles() as c:
        res = mw_concurrent_flow_batch(batch_of([2, 3]), iters=24,
                                       device="cpu")
    assert c.count == 0, f"kernel builds within a shape bucket: {c.events}"
    assert retrace.solver_cache_sizes() == before
    assert all(np.isfinite(r.alpha) and r.alpha > 0 for r in res)
