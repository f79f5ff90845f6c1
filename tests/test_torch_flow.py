"""The port's flow solvers against the reference, on identical path systems.

Tolerances, and why each holds:

* Position-ordered sums (``_fold_sum``, ``_ordered_fan_in_sum``), the dense
  incidence, the batch envelope and its fan-in tables, and the LP: exact.
  They are the same IEEE operations in the same order.
* MW alpha over a short horizon (10 iterations): rtol 1e-5 for ``gather``
  against the reference's ``scatter``/``gather`` and for ``dense`` against
  its ``dense``.  The recurrence is the reference's step for step; what
  differs is the last bit of transcendentals (XLA:CPU evaluates ``exp``,
  ``pow`` and ``2 / sqrt`` with its own approximations, e.g. ``rsqrt``,
  and rounds some values differently from torch).
* MW alpha over a full horizon (400 iterations): within 5e-3 relative, and
  never above the exact LP optimum.  The annealed softmax amplifies those
  last-bit differences over hundreds of iterations, as it amplifies the
  reassociation between the reference's own ``scatter`` and ``dense``
  backends.  Measured on these three systems (a CPU run): the gap is at
  most 1.1e-6 up to 25 iterations, then grows unevenly to at most 3.98e-3
  (``gather`` against ``scatter``, the 40-switch system); ``dense`` against
  ``dense`` reached 3.08e-3 over torch CPU thread counts 1-16 (the BLAS
  order depends on them); the reference's own ``scatter`` and ``dense``
  differ by up to 2.6e-3.  The bound sits just above the largest reading.
* Within the port, a batched solve equals the sequential one bit for bit
  under ``gather`` (CT-batch), ragged envelopes and adaptive stops included.
* The batched ``dense`` closure over each member's real extents: exact
  zeros beyond them, and on the real positions the sums of the full padded
  stack (rtol 1e-6: the CPU's plain version slices each member, so BLAS
  blocks the products differently; on the card the kernel's sums are the
  same bit for bit, held by ``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.analysis import contracts as ref_contracts
from repro.core import flow as ref_flow
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import flow as port_flow

CPU = "cpu"


def _systems():
    out = []
    for n, d, seed in ((40, 5, 0), (64, 6, 1), (30, 4, 2)):
        rt = R.jellyfish(n, d + 3, d, seed=seed)
        rps = R.build_path_system(rt, R.random_permutation_traffic(rt, seed=seed),
                                  k=8, max_slack=3)
        out.append((rps, convert.path_system_from_numpy(dataclasses.asdict(rps))))
    return out


SYSTEMS = _systems()


def test_fold_sum_and_fan_in_match_reference_bitwise():
    rng = np.random.default_rng(0)
    for n in (1, 5, 16, 37, 300):
        x = rng.random((3, n), np.float32)
        want = np.asarray(ref_flow._fold_sum(jnp.asarray(x)))
        got = port_flow._fold_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        pad = np.concatenate([x, np.zeros((3, 64 - n % 64), np.float32)], 1)
        np.testing.assert_array_equal(
            port_flow._fold_sum(torch.from_numpy(pad)).numpy(), got)
    fr = np.concatenate([rng.random((2, 50), np.float32),
                         np.zeros((2, 1), np.float32)], 1)
    tab = rng.integers(0, 51, (2, 9, 6)).astype(np.int32)
    want = np.asarray(ref_flow._ordered_fan_in_sum(jnp.asarray(fr),
                                                   jnp.asarray(tab)))
    got = port_flow._ordered_fan_in_sum(
        torch.from_numpy(fr), port_flow._columns(tab, torch.device(CPU)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_incidence_and_softmax():
    rps, pps = SYSTEMS[0]
    want = np.asarray(ref_flow.dense_incidence(jnp.asarray(rps.path_edges),
                                               rps.n_slots))
    got = port_flow.dense_incidence(torch.from_numpy(pps.path_edges),
                                    pps.n_slots)
    np.testing.assert_array_equal(got.numpy(), want)
    logits = np.random.default_rng(1).normal(size=(2, 50)).astype(np.float32)
    logits[0, :7] = -np.inf
    want = np.asarray(ref_flow._masked_softmax(jnp.asarray(logits)))
    got = port_flow._masked_softmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_batch_envelope_identical():
    refs = [r for r, _ in SYSTEMS]
    ports = [p for _, p in SYSTEMS]
    rb = ref_flow.PathSystemBatch.from_systems(refs)
    pb = port_flow.PathSystemBatch.from_systems(ports)
    for f in ("path_edges", "path_owner", "demands", "inv_cap", "slot_valid",
              "n_paths", "slot_gather", "owner_gather"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f),
                                      err_msg=f)
    ref_contracts.check_path_system_batch(pb, name="port batch")


@pytest.mark.parametrize("idx", [0, 1, 2])
@pytest.mark.parametrize("ref_be,port_be", [("scatter", "gather"),
                                            ("dense", "dense")])
def test_mw_short_horizon_matches_reference(idx, ref_be, port_be):
    rps, pps = SYSTEMS[idx]
    want = R.mw_concurrent_flow(rps, iters=10, backend=ref_be)
    got = T.mw_concurrent_flow(pps, iters=10, backend=port_be, device=CPU)
    assert got.alpha == pytest.approx(want.alpha, rel=1e-5)
    assert got.max_load == pytest.approx(want.max_load, rel=1e-5)
    np.testing.assert_allclose(got.rates, want.rates, rtol=1e-4, atol=1e-7)
    assert got.iters == want.iters == 10


def _solver_inputs(batch, seed):
    """Rates and prices as the MW step makes them: zero rates on padded
    rows (the dummy commodity has no demand), zero prices on padded slots
    (masked softmax times zero inverse capacity)."""
    rng = np.random.default_rng(seed)
    dem = np.take_along_axis(batch.demands, batch.path_owner, axis=1)
    rates = rng.random(dem.shape, np.float32) * dem
    prices = rng.random(batch.inv_cap.shape, np.float32) * batch.slot_valid \
        * batch.inv_cap
    return torch.from_numpy(rates), torch.from_numpy(prices)


def test_dense_batch_closure_over_extents_is_exact():
    ports = [p for _, p in SYSTEMS] + [port_flow._empty_path_system()]
    batch = port_flow.PathSystemBatch.from_systems(ports)
    pe = torch.from_numpy(batch.path_edges)
    B, S = batch.n_batch, batch.s_max
    n_slots = [ps.n_slots for ps in batch.systems]
    rates, prices = _solver_inputs(batch, 0)
    full = port_flow.make_congestion_fn_batch(pe, S, B, "dense")
    ext = port_flow.make_congestion_fn_batch(
        pe, S, B, "dense", extents=(batch.n_paths, n_slots))
    (fl, fc), (el, ec) = full(rates, prices), ext(rates, prices)
    b3 = torch.stack([port_flow.dense_incidence(pe[i], S) for i in range(B)])
    inv = torch.from_numpy(batch.inv_cap)
    for i, (p, s) in enumerate(zip(batch.n_paths.tolist(), n_slots)):
        # the stack's padding is not empty: sentinel hits at column s
        assert p == 0 or b3[i, :, s].any()
        assert not el[i, s:].any() and not ec[i, p:].any()
        torch.testing.assert_close(el[i, :s], fl[i, :s], rtol=1e-6, atol=0)
        torch.testing.assert_close(ec[i, :p], fc[i, :p], rtol=1e-6, atol=0)
        # what the full call computes past the extents is priced at zero
        assert not (fl[i, s:] * inv[i, s:]).any()
    # reading the padding or not gives the same bits at the same shape
    cut = b3.clone()
    for i, (p, s) in enumerate(zip(batch.n_paths.tolist(), n_slots)):
        cut[i, p:] = 0.0
        cut[i, :, s:] = 0.0
    zl, zc = port_flow.ops.congestion(cut, rates, prices)
    n = batch.n_paths.tolist()
    assert all(torch.equal(zl[i, :s], fl[i, :s])
               and torch.equal(zc[i, :p], fc[i, :p])
               for i, (p, s) in enumerate(zip(n, n_slots)))


@pytest.mark.parametrize("iters,rtol", [(10, 1e-5), (400, 5e-3)])
def test_mw_batch_dense_over_extents_matches_reference(iters, rtol):
    refs = [r for r, _ in SYSTEMS]
    ports = [p for _, p in SYSTEMS]
    want = R.mw_concurrent_flow_batch(refs, iters=iters, backend="dense")
    got = T.mw_concurrent_flow_batch(ports, iters=iters, backend="dense",
                                     device=CPU)
    for g, w in zip(got, want):
        assert g.method == "mw-batch-dense" and g.iters == iters
        assert g.alpha == pytest.approx(w.alpha, rel=rtol)
        assert np.all(np.isfinite(g.rates))


def test_mw_batch_short_horizon_matches_reference():
    refs = [r for r, _ in SYSTEMS]
    ports = [p for _, p in SYSTEMS]
    want = R.mw_concurrent_flow_batch(refs, iters=10, backend="gather")
    got = T.mw_concurrent_flow_batch(ports, iters=10, backend="gather",
                                     device=CPU)
    for g, w in zip(got, want):
        assert g.alpha == pytest.approx(w.alpha, rel=1e-5)
    want = R.mw_concurrent_flow_batch(refs, iters=10, backend="dense")
    got = T.mw_concurrent_flow_batch(ports, iters=10, backend="dense",
                                     device=CPU)
    for g, w in zip(got, want):
        assert g.alpha == pytest.approx(w.alpha, rel=1e-5)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_mw_full_horizon_within_drift_and_below_lp(idx):
    rps, pps = SYSTEMS[idx]
    lp = R.lp_concurrent_flow(rps).alpha
    assert T.lp_concurrent_flow(pps).alpha == lp
    for ref_be, port_be in (("scatter", "gather"), ("dense", "dense")):
        want = R.mw_concurrent_flow(rps, iters=400, backend=ref_be).alpha
        got = T.mw_concurrent_flow(pps, iters=400, backend=port_be,
                                   device=CPU).alpha
        assert got == pytest.approx(want, rel=5e-3)
        assert 0.9 * lp < got <= lp * (1 + 1e-6)


def test_ct_batch_equals_sequential_bitwise():
    ports = [p for _, p in SYSTEMS]
    kw = dict(iters=300, backend="gather", early_stop=True, check_every=25,
              rel_tol=1e-3)
    seq = [T.mw_concurrent_flow(p, device=CPU, **kw) for p in ports]
    bat = T.mw_concurrent_flow_batch(ports, device=CPU, **kw)
    for s, b in zip(seq, bat):
        assert b.alpha == s.alpha
        assert b.iters == s.iters
        assert np.array_equal(b.rates, s.rates)
    # a probe-style target stop, and an unbucketed explicit batch
    seq = [T.mw_concurrent_flow(p, iters=200, backend="gather",
                                target_alpha=0.5, device=CPU) for p in ports]
    batch = port_flow.PathSystemBatch.from_systems(ports, bucket=False)
    bat = T.mw_concurrent_flow_batch(batch, iters=200, backend="gather",
                                     target_alpha=0.5, device=CPU)
    assert [b.alpha for b in bat] == [s.alpha for s in seq]
    assert [b.iters for b in bat] == [s.iters for s in seq]


def test_shared_batch_matches_reference_and_sequential():
    rps, pps = SYSTEMS[0]
    dem = np.stack([pps.demands, 0.5 * pps.demands]).astype(np.float32)
    want = R.mw_concurrent_flow_batch(
        ref_flow.PathSystemBatch.from_shared(rps, dem), iters=10,
        backend="gather")
    shared = port_flow.PathSystemBatch.from_shared(pps, dem)
    got = T.mw_concurrent_flow_batch(shared, iters=10, backend="gather",
                                     device=CPU)
    for g, w in zip(got, want):
        assert g.alpha == pytest.approx(w.alpha, rel=1e-5)
    half = dataclasses.replace(pps, demands=dem[1])
    seq = T.mw_concurrent_flow(half, iters=10, backend="gather", device=CPU)
    assert got[1].alpha == seq.alpha


def test_warm_start_matches_reference():
    rps, pps = SYSTEMS[1]
    prev_r = R.mw_concurrent_flow(rps, iters=50, backend="scatter")
    rows = np.arange(rps.n_paths)
    rps2 = dataclasses.replace(rps, row_map=rows)
    pps2 = dataclasses.replace(pps, row_map=rows)
    want = R.mw_concurrent_flow(rps2, iters=10, backend="scatter", warm=prev_r)
    got = T.mw_concurrent_flow(pps2, iters=10, backend="gather",
                               warm=prev_r.rates, device=CPU)
    assert got.alpha == pytest.approx(want.alpha, rel=1e-5)


def test_empty_and_throughput_dispatch():
    empty = port_flow._empty_path_system()
    assert T.mw_concurrent_flow(empty, device=CPU).alpha == 0.0
    res = T.mw_concurrent_flow_batch([empty, empty], device=CPU)
    assert [r.alpha for r in res] == [0.0, 0.0]
    rps, pps = SYSTEMS[2]
    assert T.throughput(pps, device=CPU).method == "lp"
    assert T.throughput(pps, method="mw", iters=20,
                        device=CPU).method.startswith("mw")
    with pytest.raises(ValueError, match="unknown congestion backend"):
        T.mw_concurrent_flow(pps, backend="scatter", device=CPU)
