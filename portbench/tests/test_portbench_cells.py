"""Each cell's driver against its plain reference, at tiny sizes on the CPU:
sound runs come out correct; the control in the program's place and each
fault planted in the program come out not correct."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny


@pytest.mark.parametrize("kind", ["probe", "expand", "sim"])
def test_sound_run_is_correct(kind, monkeypatch):
    tiny.mw_everywhere(monkeypatch)
    line = tiny.run(tiny.cell(kind))
    assert line["attempted"] >= 1
    assert line["failed"] == 0
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("kind", ["probe", "expand", "sim"])
def test_control_is_not_correct(kind, monkeypatch):
    tiny.mw_everywhere(monkeypatch)
    line = tiny.run(tiny.cell(kind), control=True)
    assert not line["correct"], line["checks"]


def _frozen_mw(monkeypatch):
    from repro_torch.core import flow

    monkeypatch.setattr(flow, "_mw_steps",
                        lambda fused, seg_norm, carry, *a, **k: carry)


def _half_batch(monkeypatch):
    from repro_torch import capacity

    plain = capacity.mw_concurrent_flow_batch

    def half(systems, **kw):
        kept = plain(systems[: (len(systems) + 1) // 2], **kw)
        return kept + [kept[0]] * (len(systems) - len(kept))

    monkeypatch.setattr(capacity, "mw_concurrent_flow_batch", half)


def _altered_alpha(monkeypatch):
    from repro_torch import capacity

    plain = capacity.probe_full_capacity

    def altered(*a, **kw):
        pr = plain(*a, **kw)
        pr.mw_results[0].alpha *= 1.001
        return pr

    monkeypatch.setattr(capacity, "probe_full_capacity", altered)


def _altered_path(monkeypatch):
    from repro_torch import capacity

    plain = capacity.build_path_system_batch

    def altered(*a, **kw):
        batch = plain(*a, **kw)
        pe = batch.systems[0].path_edges
        pe[0, 0], pe[1, 0] = pe[1, 0], pe[0, 0]
        return batch

    monkeypatch.setattr(capacity, "build_path_system_batch", altered)


@pytest.mark.parametrize("fault", [_frozen_mw, _half_batch, _altered_alpha,
                                   _altered_path])
def test_probe_fault_is_not_correct(fault, monkeypatch):
    tiny.mw_everywhere(monkeypatch)
    fault(monkeypatch)
    # one rung whose reference alpha lies clear above 1 (about 1.04-1.13)
    c = tiny.cell("probe", servers={"first": 100, "last": 100, "step": 20})
    assert not tiny.run(c)["correct"]


def _expand_fault(name):
    def install(driver):
        p = driver.p
        if name == "unchanged":
            p["update"] = lambda ps, cur, new, comm, device: ps
        elif name == "lambda2":
            plain = p["lam"]
            p["lam"] = lambda *a, **kw: plain(*a, **kw) * 1.001
        elif name == "alpha":
            plain = p["mw"]

            def altered(*a, **kw):
                res = plain(*a, **kw)
                res.alpha *= 1.001
                return res

            p["mw"] = altered
    return install


@pytest.mark.parametrize("name", ["unchanged", "lambda2", "alpha"])
def test_expand_fault_is_not_correct(name, monkeypatch):
    line = tiny.run(tiny.cell("expand"), hook=_expand_fault(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["probe.half_iters", "expand.half_iters"])
def test_planted_fault_is_not_correct(name, monkeypatch):
    """The faults ``readings.py`` plants at the cells' size, here at tiny
    size: each comes out not correct by ``alpha_shortfall``, and by it
    alone (the MW's result is held against the reference's, not only
    against its own rates)."""
    tiny.mw_everywhere(monkeypatch)
    kind = name.split(".")[0]
    # the probe's on one rung whose alpha stays under 1 (about 0.7)
    c = (tiny.cell(kind, servers={"first": 140, "last": 140, "step": 20})
         if kind == "probe" else tiny.cell(kind))
    line = tiny.run(c, hook=faults.install(name))
    assert not line["correct"], line["checks"]
    over = [n for n, c in line["checks"].items() if c["value"] > c["limit"]]
    assert over == ["alpha_shortfall"], line["checks"]


def _sim_fault(name):
    def install(driver):
        plain = driver.simulate

        def faulty(batch, workload, arrivals, **kw):
            if name == "half":  # the second half of the instances left out
                res = plain(batch, workload, arrivals=arrivals, **kw)
                B = len(batch.systems)
                res.throughput[:, B // 2:] = 0.0
                return res
            res = plain(batch, workload, arrivals=arrivals, **kw)
            if name == "unchanged":  # every step leaves the flows as they were
                res.throughput[:] = 0.0
                res.active[:] = 0
            else:  # one step's throughput altered where it is produced
                res.throughput[0, 0] *= 1.01
            return res

        driver.simulate = faulty
    return install


@pytest.mark.parametrize("name", ["unchanged", "half", "altered"])
def test_sim_fault_is_not_correct(name):
    line = tiny.run(tiny.cell("sim"), hook=_sim_fault(name))
    assert not line["correct"], line["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the program's kernels "
                    "have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probe", "expand", "sim"])
def test_tiny_cell_on_card_is_correct(kind, card, monkeypatch):
    tiny.mw_everywhere(monkeypatch)
    line = harness.execute(tiny.cell(kind), 2**31 + 5, 0.2, True, card, 0.0)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_alpha_gap_reads_the_rates_it_is_given():
    """The certificate behind ``alpha_gap``: the alpha a rate vector carries
    on a table, here a two-path, two-slot table by hand."""
    from portbench.reference import mw

    routes = types.SimpleNamespace(
        path_edges=np.array([[0], [1]]), path_owner=np.array([0, 0]),
        demands=np.array([2.0]), n_paths=2, n_slots=2)
    assert mw.achieved_alpha(routes, np.array([1.0, 1.0])) == pytest.approx(1.0)
    assert mw.achieved_alpha(routes, np.array([1.0, 0.5])) == pytest.approx(0.75)
    assert np.isnan(mw.achieved_alpha(routes, np.array([1.0])))
