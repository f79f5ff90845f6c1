"""The paper's comparison topology families, placement and the edge LP:
port against reference, on the CPU.

Tolerances, and why each holds:

* Small-world datacenters (Fig 3), degree-diameter graphs (Fig 2) and
  locality-restricted Jellyfish (Fig 12): equal by ``edge_fingerprint`` over
  several seeds — the modules are the reference's numpy code with the same
  RNG call order.
* ``plan_cables``: every count equal, every length equal (the same float64
  operations in the same order).
* ``lp_edge_concurrent_flow``: rtol 1e-9 against the reference (the same
  sparse LP handed to the same HiGHS), and within 2e-2 of the port's path
  LP, as the reference's own ``tests/test_flow.py`` holds its pair.
* The paper's closed form for the Bollobás bound and the Fig 4 path-length
  claim, on the port.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T

CPU = "cpu"


def _same(a, b):
    assert T.edge_fingerprint(a) == R.edge_fingerprint(b)
    assert a.n_switches == b.n_switches and a.name == b.name
    np.testing.assert_array_equal(a.ports, b.ports)
    np.testing.assert_array_equal(a.net_degree, b.net_degree)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family,args", [
    ("swdc_ring", (64, 8)),
    ("swdc_torus2d", (8, 8)),
    ("swdc_hex3d", (4, 3, 8)),
    ("swdc_hex3d", (6, 2, 8)),
])
def test_swdc_matches_reference(family, args, seed):
    got = getattr(T, family)(*args, seed=seed)
    want = getattr(R, family)(*args, seed=seed)
    _same(got, want)
    assert got.meta["kind"] == "swdc"


def test_swdc_hex3d_rejects_odd_side():
    with pytest.raises(ValueError, match="even side"):
        T.swdc_hex3d(5, 2, 8)


@pytest.mark.parametrize("name", sorted(R.DD_CATALOG))
def test_degree_diameter_matches_reference(name):
    assert sorted(T.DD_CATALOG) == sorted(R.DD_CATALOG)
    _, n, deg, diam = T.DD_CATALOG[name]
    assert R.DD_CATALOG[name][1:] == (n, deg, diam)
    for ports in (deg, deg + 3):
        got = T.degree_diameter_graph(name, ports)
        _same(got, R.degree_diameter_graph(name, ports))
        assert got.meta["diameter"] == diam
    with pytest.raises(ValueError, match="needs k"):
        T.degree_diameter_graph(name, deg - 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("local", [0, 2, 5])
def test_localized_jellyfish_and_cables_match_reference(local, seed):
    got = T.localized_jellyfish(6, 8, 10, 8 if local < 5 else 6, local,
                                seed=seed)
    want = R.localized_jellyfish(6, 8, 10, 8 if local < 5 else 6, local,
                                 seed=seed)
    _same(got, want)
    np.testing.assert_array_equal(got.meta["pod_of"], want.meta["pod_of"])
    for center in (True, False):
        g = T.plan_cables(got, cluster_center=center)
        w = R.plan_cables(want, cluster_center=center)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert g.summary() == w.summary()
    plain = T.jellyfish(48, 10, 8, seed=seed)
    assert dataclasses.asdict(T.plan_cables(plain, rack_pitch_m=1.2)) == \
        dataclasses.asdict(R.plan_cables(R.jellyfish(48, 10, 8, seed=seed),
                                         rack_pitch_m=1.2))


def test_localized_jellyfish_validates():
    with pytest.raises(ValueError, match="cannot exceed"):
        T.localized_jellyfish(4, 8, 10, 6, 7)
    with pytest.raises(ValueError, match="switches per pod"):
        T.localized_jellyfish(4, 4, 10, 6, 4)


@pytest.mark.parametrize("n,ports,net,seed", [(16, 6, 4, 2), (12, 8, 5, 0),
                                              (20, 6, 3, 1)])
def test_edge_lp_matches_reference_and_path_lp(n, ports, net, seed):
    top = T.jellyfish(n, ports, net, seed=seed)
    comm = T.random_permutation_traffic(top, seed=seed + 1)
    rtop = R.jellyfish(n, ports, net, seed=seed)
    rcomm = R.random_permutation_traffic(rtop, seed=seed + 1)
    got = T.lp_edge_concurrent_flow(top, comm)
    assert got == pytest.approx(R.lp_edge_concurrent_flow(rtop, rcomm),
                                rel=1e-9)
    ps = T.build_path_system(top, comm, k=8, max_slack=4, device=CPU)
    assert T.lp_concurrent_flow(ps).alpha == pytest.approx(got, rel=2e-2)


def test_edge_lp_on_a_swdc_ring():
    top = T.swdc_ring(24, 8, seed=3)
    comm = T.random_permutation_traffic(top, seed=4)
    rtop = R.swdc_ring(24, 8, seed=3)
    want = R.lp_edge_concurrent_flow(rtop,
                                     R.random_permutation_traffic(rtop, seed=4))
    assert T.lp_edge_concurrent_flow(top, comm) == pytest.approx(want,
                                                                 rel=1e-9)


# --------------------------------------------------------------------------- #
# the paper-claims tests that read these families, on the port
# --------------------------------------------------------------------------- #


def test_bollobas_formula_values():
    # spot-check the closed form from §4.1
    assert T.bollobas_bound(48, 36) == pytest.approx(
        min((18 - np.sqrt(36 * np.log(2))) / 12, 1.0)
    )
    assert T.bollobas_bound(10, 9) == 1.0  # saturates at 1
    with pytest.raises(ValueError):
        T.bollobas_bound(8, 8)


def test_jellyfish_shorter_paths_than_fattree():
    ft = T.fattree(8)
    eq = T.fattree_equipment(8)
    # same switching equipment, same server count
    servers_per = eq["servers"] // eq["switches"] + 1
    top = T.jellyfish(eq["switches"], 8, 8 - servers_per, seed=0)
    assert T.path_stats(top).mean < T.path_stats(ft).mean
