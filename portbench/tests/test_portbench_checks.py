"""The pieces behind the checks and the device metrics: the reference's
warm start against the program's, the probe's ladder, the shortfall, the
congestion label under both backends and the attribution of device time
to a label."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import devtrace, labels
from portbench.kinds import probe
from portbench.reference import mw, paths
from portbench.reference.frozen import expansion as fexp
from portbench.reference.frozen import jellyfish as fjelly
from portbench.reference.frozen import traffic as ftraffic
from portbench.reference.warm import warm_split


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_warm_start_is_the_programs(seed):
    """``reference/warm.py`` states the splice rule and the warm split from
    their definition; on the program's own delta table (equal to the
    reference's) and one rate vector both start every row alike."""
    from repro_torch.core import (
        build_path_system,
        expand_to,
        extend_server_permutation,
        jellyfish,
        permutation_commodities,
        random_server_permutation,
        update_path_system,
    )
    from repro_torch.core.flow import _warm_split

    n, ports, deg, k, slack = 60, 10, 6, 8, 3
    top = jellyfish(n, ports, deg, seed=seed)
    perm = random_server_permutation(top.n_servers, seed=seed + 10)
    comm = permutation_commodities(top, perm)
    ps = build_path_system(top, comm, k=k, max_slack=slack, device="cpu")
    erng = np.random.default_rng(seed + 20)
    new = expand_to(top, n + 4, ports, deg, seed=erng)
    perm2 = extend_server_permutation(perm, new.n_servers, seed=erng)
    comm2 = permutation_commodities(new, perm2)
    ps2 = update_path_system(ps, top, new, comm2, device="cpu")
    rates = np.random.default_rng(seed).uniform(0.1, 1.0, ps.n_paths)
    want = _warm_split(ps2, rates.astype(np.float32))

    rtop = fjelly.jellyfish(n, ports, deg, seed=seed)
    rperm = ftraffic.random_server_permutation(rtop.n_servers, seed=seed + 10)
    rcomm = ftraffic.permutation_commodities(rtop, rperm)
    erng = np.random.default_rng(seed + 20)
    rnew = fexp.expand_to(rtop, n + 4, ports, deg, seed=erng)
    rperm2 = ftraffic.extend_server_permutation(rperm, rnew.n_servers, seed=erng)
    rcomm2 = ftraffic.permutation_commodities(rnew, rperm2)
    d0 = paths.hop_distances(n, rtop.edges)
    d1 = paths.hop_distances(rnew.n_switches, rnew.edges)
    r0 = paths.route_tables(n, rtop.edges, rcomm.src, rcomm.dst, rcomm.demand,
                            k, slack, d0)
    r1 = paths.route_tables(rnew.n_switches, rnew.edges, rcomm2.src,
                            rcomm2.dst, rcomm2.demand, k, slack, d1)
    assert probe.same_tables(probe.tables(ps2), r1)
    got, kept = warm_split(rtop, rcomm, r0, rates.astype(np.float32).astype(
        np.float64), rnew, rcomm2, r1, k, slack, d0, d1)
    assert 0.0 < kept < 1.0
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=1e-6)


def test_probe_ladder_alternates_from_both_ends():
    lad = probe.ladder({"first": 4000, "last": 4640, "step": 80})
    assert lad == [4000, 4640, 4080, 4560, 4160, 4480, 4240, 4400, 4320]
    assert probe.ladder({"first": 1, "last": 4, "step": 1}) == [1, 4, 2, 3]


def test_shortfall_is_one_sided_and_capped():
    assert mw.shortfall(0.9, 1.0) == pytest.approx(0.1)
    assert mw.shortfall(1.1, 1.0) == 0.0
    assert mw.shortfall(1.02, 1.3, target=1.0) == 0.0
    assert mw.shortfall(0.99, 1.3, target=1.0) == pytest.approx(0.01)
    assert mw.shortfall(float("nan"), 1.0) == float("inf")


def test_device_time_is_attributed_to_the_label_it_was_launched_in():
    """Kernels of any name count for the label whose host interval holds
    their launch: by the runtime call's correlation, else by the operator."""
    labs = [("portbench/kernels.congestion", 10.0, 20.0),
            ("portbench/kernels.congestion", 30.0, 40.0),
            ("portbench/window", 0.0, 100.0)]
    launch = {1: 12.0, 2: 25.0, 3: 39.0, ("op", 7): 31.0}
    dev = [("congestion_band", 50.0, 51.0e0 + 1e6, 1, 0),  # 1 s, inside
           ("index_select", 60.0, 60.0 + 2e6, 2, 0),  # 2 s, outside
           ("gather_kernel", 70.0, 70.0 + 4e6, 3, 0),  # 4 s, inside
           ("cat", 80.0, 80.0 + 8e6, 99, 7),  # 8 s, by its operator
           ("lost", 90.0, 90.0 + 16e6, 98, 0)]  # no launch known
    got = devtrace.attribute(dev, labs, launch, {"kernels.congestion"})
    assert got["kernels.congestion"] == pytest.approx(1.0 + 4.0 + 8.0, rel=1e-6)
    assert devtrace.attribute(dev, labs, launch, {"other"}) == {}


@pytest.mark.parametrize("backend", ["gather", "dense"])
def test_congestion_label_wraps_every_backend(backend):
    """Under either backend every MW iteration's product runs inside the
    label, and so do the operations a gather is made of."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.capacity import jellyfish_same_equipment
    from repro_torch.core import (
        build_path_system,
        mw_concurrent_flow_batch,
        random_permutation_traffic,
    )

    top = jellyfish_same_equipment(30, 8, 90, seed=3)
    systems = [build_path_system(top, random_permutation_traffic(top, seed=m),
                                 k=8, max_slack=3, device="cpu", cache=False)
               for m in range(2)]
    with labels.congestion_labels(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        res = mw_concurrent_flow_batch(systems, iters=20, backend=backend,
                                       device="cpu")
    _, labs, launch = devtrace._events(prof)
    inside = [lab for lab in labs
              if lab[0] == f"portbench/{labels.CONGESTION}"]
    assert len(inside) >= max(r.iters for r in res)
    ops = [ev for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith("aten::")]
    held = [ev for ev in ops
            if any(a <= ev.start_ns() / 1e3 <= b for _, a, b in inside)]
    assert held
    # the factories are whole again once the labels are taken out
    from repro_torch.core import flow

    assert flow.make_congestion_fn_batch.__name__ == "make_congestion_fn_batch"
