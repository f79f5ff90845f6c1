#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the paper's Fig 1c capacity path, the spectral lambda_2 path and the
incremental-expansion path at full width on the card and prints one JSON
line per phase:

1. ``build``   compile the hand-written CUDA kernels from ``csrc/`` (one
               ``nvcc`` per source, started together).
2. ``kernel_checks``  hold every kernel against its plain torch version on
               the card, on inputs at the shapes the main path gives it
               (min-plus and admission exact; congestion within rtol 1e-5;
               each member of a batched congestion call equal to the single
               call bit for bit; matmul within rtol 1e-5 at the spectral
               path's 8192 x 8192 x 8, at 1024^3 and in float64, with TF32
               off), and time kernel, plain version and, where
               one exists, the one PyTorch library call computing the same
               function (device time per call from ``torch.profiler``, or
               from CUDA events where two profiler sessions record no
               device activity, with the timer named; the wrapper's
               per-call stream time from CUDA events beside it).
3. ``apsp``    APSP of a seeded RRG(8192, 48 ports, degree 36) through
               ``apsp_minplus_blocked`` on the card, equal to the host BFS.
   ``spectral``  lambda_2 of the same RRG's Laplacian by
               ``ops.power_iteration_lambda2`` on the card (300 iterations,
               a block of 8, one fixed start block): 301 matmul launches,
               within rtol 1e-4 of the CPU run from the same start block,
               and not below ``scipy.sparse.linalg.eigsh``'s lambda_2 by
               more than rtol 1e-4 (its gap above is reported).
4. ``probe``   the full-width probe: ``capacity.probe_full_capacity`` (the
               body of ``supports_full_capacity``, returning the solves
               behind its verdict) on the equipment of a k=24 fat-tree
               (720 switches x 24 ports) with 4320 servers, 3 traffic
               matrices, 500 iterations, the batched dense kernel; then the
               probe's solve alone with ``dense`` and with ``gather``.
               Path systems built on the card equal those built on the CPU.
   ``alpha_of``  one sequential ``alpha_of`` (the single-incidence kernel).
   ``expansion``  a Jellyfish of 720 switches x 24 ports (6 servers each)
               under a random server permutation, grown to 792 switches in
               4 steps of 18 ``add_switch`` calls (``expand_to``), then 5 %
               of its links failed: at each step ``update_path_system`` on
               the card equals ``build_path_system(..., cache=False)`` on
               the card exactly, a warm-started MW solve is set against a
               cold one, and lambda_2 of the step's topology is computed.
5. ``bisection``  a whole ``max_servers_at_full_capacity`` search with
               ``method="mw"`` at the k=24 equipment (k=16 when the probe
               shows it would not fit the time budget), plus a small
               bisection whose count must equal the CPU run's.
6. ``kernels`` per kernel: launches on each path (``spectral``, the probe,
               ``alpha_of``, ``expansion`` and the bisection, each run with
               the counts set to 0 just before it and read just after; each
               kernel must be launched by the paths that use it), largest
               difference from the plain version, and the times of phase 2
               beside the card's bound for the work.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without that line; so it does without a GPU, and when the
repository's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
#: and the CUDA cores' FP32 rate as instructions issued per second (the
#: 67 TFLOP/s peak counts a fused multiply-add as two operations).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2

#: Fig 1c probe size: the equipment of a k=24 fat-tree (720 switches of 24
#: ports, 3456 servers in the fat-tree) hosting 1.25x the servers.
K_FULL = 24
PROBE_SERVERS = 4320
#: Expansion path: 720 switches of 24 ports, 18 to the network (6 servers
#: each, the probe's equipment), grown by 4 steps of 18 switches.
EXP_SWITCHES, EXP_PORTS, EXP_NET = 720, 24, 18
EXP_STEPS, EXP_STEP_SWITCHES = 4, 18
EXP_FAIL_FRACTION = 0.05
#: Spectral path: power iterations and block width.
SPECTRAL_ITERS, SPECTRAL_BLOCK = 300, 8
#: Seconds the whole script aims to stay within (half the run's limit).
TIME_BUDGET_S = 600.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound_ms(n_bytes: float, n_instr: float) -> tuple[float, str]:
    """The least time for the work: bytes moved over the HBM rate, or FP32
    instructions (an FMA, an add and a min are one each) over the issue
    rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch.profiler import ProfilerActivity, profile

    import scipy.sparse as sparse
    from scipy.sparse.linalg import eigsh

    from repro_torch import capacity, kernels, obs
    from repro_torch.analysis.contracts import check_path_system
    from repro_torch.core import (
        PathSystemBatch,
        build_path_system,
        expand_to,
        extend_server_permutation,
        fail_links,
        fattree_equipment,
        jellyfish,
        mw_concurrent_flow,
        permutation_commodities,
        random_permutation_traffic,
        random_server_permutation,
        update_path_system,
    )
    from repro_torch.core import routing
    from repro_torch.core.flow import _empty_path_system, dense_incidence
    from repro_torch.core.metrics import apsp_hops_blocked
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.kernels import _build, admission as adm_mod, ops
    from repro_torch.kernels.admission import admission, admission_ref
    from repro_torch.kernels.congestion import congestion, congestion_ref
    from repro_torch.kernels.minplus import minplus, minplus_ref
    from repro_torch.kernels.power import matmul, matmul_ref

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    def sync_time(fn, reps: int) -> float:
        """Mean milliseconds per call of ``fn()`` between two CUDA events:
        the stream's time, host launch overhead included where the calls
        are too short to keep the card busy."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def device_ms(fn, reps: int, kernels_named=None) -> tuple[float, str]:
        """Mean device milliseconds per call of ``fn()``, and the timer.

        From the profiler: with ``kernels_named``, the sum over those
        kernels (each launched once per call) of each kernel's mean time
        per recorded launch; without, every device operation ``fn``
        launched (runtime API entries excluded), divided by ``reps``.
        CUPTI tracing sometimes records no device activity for a session;
        then a second session is tried, and if that sees none either the
        time is the stream's time per call from CUDA events (``sync_time``,
        host launch overhead included), and the timer says so."""
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            total_us = 0.0
            for ev in prof.key_averages():
                if kernels_named is None:
                    if not ev.key.startswith("cuda"):
                        total_us += ev.device_time_total / reps
                elif any(k in ev.key for k in kernels_named) and ev.count:
                    total_us += ev.device_time_total / ev.count
            if total_us > 0:
                return total_us / 1e3, "profiler"
        print(f"chip_smoke: the profiler saw no device time "
              f"({kernels_named or 'plain'}); timing with CUDA events",
              file=sys.stderr, flush=True)
        return sync_time(fn, reps), "events"

    def timings(kernel_fn, names, plain_fn, library_fn, reps) -> dict:
        """Kernel, plain and library device times per call with the timer
        each came from, plus the kernel wrapper's per-call stream time."""
        out = {}
        out["ms"], out["timer"] = device_ms(kernel_fn, reps, names)
        out["plain_ms"], out["plain_timer"] = device_ms(plain_fn,
                                                        max(reps // 2, 2))
        out["library_ms"], out["library_timer"] = (
            (None, None) if library_fn is None
            else device_ms(library_fn, max(reps // 2, 2)))
        out["call_ms"] = sync_time(kernel_fn, reps)
        return out

    # ---- 1. build --------------------------------------------------------- #
    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": per_kernel,
          "build_dir": str(_build.BUILD_DIR.relative_to(ROOT))})

    # ---- 2. every kernel against its plain version ------------------------ #
    eq = fattree_equipment(K_FULL)
    n_sw, ports = eq["switches"], eq["ports_per_switch"]
    top = capacity.jellyfish_same_equipment(n_sw, ports, PROBE_SERVERS, seed=0)

    # the probe's own path systems, built on the card; the largest admission
    # call of the build is kept as that kernel's main-path input
    captured = {}
    plain_admission = adm_mod.admission

    def recording_admission(d, r, c, p):
        if d.numel() > captured.get("cells", -1):
            captured.update(cells=d.numel(), args=(d.clone(), r.clone(),
                                                   c.clone(), p.clone()))
        return plain_admission(d, r, c, p)

    adm_mod.admission = recording_admission
    try:
        clear_routing_cache()
        systems = [
            build_path_system(top, random_permutation_traffic(top, seed=s),
                              k=8, max_slack=3, device=dev)
            for s in range(3)
        ]
    finally:
        adm_mod.admission = plain_admission

    results = {}
    # min-plus: the first APSP squaring of the probe topology (720 x 720)
    a = torch.from_numpy(top.adjacency()).to(dev)
    d0 = torch.where(a > 0, 1.0, float("inf")).to(torch.float32)
    d0.fill_diagonal_(0.0)
    got = minplus(d0, d0)
    want = minplus_ref(d0, d0)
    check(torch.equal(got, want), "min-plus kernel differs from plain")
    n = d0.shape[0]
    # an add and a min per (i, j, k)
    b_ms, b_by = bound_ms(4.0 * 3 * n * n, 2.0 * n ** 3)
    results["minplus"] = {
        "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
        "shape": [n, n, n],
        **timings(lambda: minplus(d0, d0), ["minplus_kernel"],
                  lambda: minplus_ref(d0, d0), None, 20),
    }

    # admission: the largest level of the probe's builds
    d, r, c, p = captured["args"]
    got = admission(d, r, c, p)
    want = admission_ref(d, r, c, p)
    check(torch.equal(got, want), "admission kernel differs from plain")
    m, cc = d.shape
    w = p.shape[1]
    # a compare per cell, and one per prefix column
    b_ms, b_by = bound_ms(4.0 * (2 * m * cc + m + m * w) + m * cc,
                          m * cc * (1.0 + w))
    results["admission"] = {
        "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
        "shape": [m, cc, w],
        **timings(lambda: admission(d, r, c, p), ["admission_kernel"],
                  lambda: admission_ref(d, r, c, p), None, 50),
    }
    del d, r, c, p, captured

    rng = np.random.default_rng(0)

    # congestion, single: the sequential solve's unpadded (P, S) incidence
    ps0 = systems[0]
    b1 = dense_incidence(torch.from_numpy(ps0.path_edges).to(dev), ps0.n_slots)
    P1, S1 = b1.shape
    r1 = torch.from_numpy(rng.random(P1, np.float32)).to(dev)
    w1 = torch.from_numpy(rng.random(S1, np.float32) / S1).to(dev)
    l_k, c_k = congestion(b1, r1, w1)
    l_p, c_p = congestion_ref(b1, r1, w1)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-9)
    err1 = max(float((l_k - l_p).abs().max()), float((c_k - c_p).abs().max()))
    # two FMAs per element of B: one into loads, one into costs
    b_ms, b_by = bound_ms(4.0 * (P1 * S1 + 2 * P1 + 2 * S1), 2.0 * P1 * S1)
    cong_names = ["congestion_band_kernel", "congestion_fold_kernel"]
    results["congestion"] = {
        "max_abs_err": err1, "bound_ms": b_ms, "bound_by": b_by,
        "shape": [P1, S1],
        **timings(lambda: congestion(b1, r1, w1), cong_names,
                  lambda: congestion_ref(b1, r1, w1),
                  lambda: (torch.mv(b1.T, r1), torch.mv(b1, w1)), 20),
    }

    # congestion, batched: the probe's stacked incidence, as the batched
    # solver pads it (3 matrices + 1 empty filler, bucketed envelope)
    batch = PathSystemBatch.from_systems(systems + [_empty_path_system()])
    Bt, Pb, Sb = batch.n_batch, batch.p_max, batch.s_max
    b3 = torch.zeros((Bt, Pb, Sb), dtype=torch.float32, device=dev)
    pe3 = torch.from_numpy(batch.path_edges).to(dev)
    for i in range(Bt):
        b3[i] = dense_incidence(pe3[i], Sb)
    r3 = torch.from_numpy(rng.random((Bt, Pb), np.float32)).to(dev)
    w3 = torch.from_numpy(rng.random((Bt, Sb), np.float32) / Sb).to(dev)
    l_k, c_k = congestion(b3, r3, w3)
    l_p, c_p = congestion_ref(b3, r3, w3)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-9)
    err3 = max(float((l_k - l_p).abs().max()), float((c_k - c_p).abs().max()))
    for i in range(Bt):
        l1, c1 = congestion(b3[i], r3[i].contiguous(), w3[i].contiguous())
        check(torch.equal(l1, l_k[i]) and torch.equal(c1, c_k[i]),
              f"batched congestion member {i} differs from the single call")
    # the padded member 0 equals the unpadded single call on the same data;
    # as in the solver, the padded rows ship no rate and the padded slots
    # (where the member's own padding sentinel lands) carry no price
    r_pad = r3[0].clone()
    r_pad[P1:] = 0.0
    w_pad = w3[0].clone()
    w_pad[S1:] = 0.0
    l_pad, c_pad = congestion(b3[0], r_pad, w_pad)
    l_un, c_un = congestion(b3[0, :P1, :S1].contiguous(),
                            r_pad[:P1].contiguous(), w_pad[:S1].contiguous())
    check(torch.equal(l_pad[:S1], l_un) and torch.equal(c_pad[:P1], c_un),
          "zero padding changed the congestion kernel's sums")
    # the bound counts the three real members' incidences; the stack the
    # kernel reads also holds the empty filler member and the bucketed
    # padding, whose share is reported beside it
    real_cells = sum(ps.n_paths * ps.n_slots for ps in systems)
    real_bytes = 4.0 * sum(ps.n_paths * ps.n_slots + 2 * ps.n_paths
                           + 2 * ps.n_slots for ps in systems)
    b_ms, b_by = bound_ms(real_bytes, 2.0 * real_cells)
    padded_bytes = 4.0 * Bt * (Pb * Sb + 2 * Pb + 2 * Sb)
    pad_ms, _ = bound_ms(padded_bytes, 2.0 * Bt * Pb * Sb)
    results["congestion_batch"] = {
        "max_abs_err": err3, "bound_ms": b_ms, "bound_by": b_by,
        "padded_bound_ms": pad_ms,
        "padding_share": 1.0 - real_bytes / padded_bytes,
        "shape": [Bt, Pb, Sb], "stack_bytes": 4 * Bt * Pb * Sb,
        **timings(lambda: congestion(b3, r3, w3), cong_names,
                  lambda: congestion_ref(b3, r3, w3),
                  lambda: [(torch.mv(b3[i].T, r3[i]), torch.mv(b3[i], w3[i]))
                           for i in range(Bt)], 10),
    }
    del b1, b3, l_k, c_k, l_p, c_p, pe3
    torch.cuda.empty_cache()

    # matmul: the spectral path's A @ Q, the RRG(8192, 48, 36) adjacency of
    # phase 3 times the column-major Q that torch.linalg.qr returns for an
    # 8192 x 8 block; float32 throughout (TF32 is off, set above, so the
    # plain and library products are full float32 too)
    rrg = jellyfish(8192, 48, 36, seed=0)
    adj = rrg.adjacency()
    a_rrg = torch.from_numpy(adj).to(dev)
    q8, _ = torch.linalg.qr(torch.from_numpy(
        rng.standard_normal((adj.shape[0], SPECTRAL_BLOCK)).astype(np.float32)
    ).to(dev))
    got = matmul(a_rrg, q8)
    want = matmul_ref(a_rrg, q8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err_mm = float((got - want).abs().max())
    # one square float32 shape and one float64 shape, for correctness
    sq = [torch.from_numpy(rng.random((1024, 1024), np.float32)).to(dev)
          for _ in range(2)]
    got_sq, want_sq = matmul(sq[0], sq[1]), matmul_ref(sq[0], sq[1])
    torch.testing.assert_close(got_sq, want_sq, rtol=1e-5, atol=1e-5)
    f64 = [torch.from_numpy(rng.standard_normal(s)).to(dev)
           for s in ((1000, 700), (700, 130))]
    got_64, want_64 = matmul(*f64), matmul_ref(*f64)
    torch.testing.assert_close(got_64, want_64, rtol=1e-12, atol=1e-12)
    nm, km = a_rrg.shape
    # one FMA per (i, j, k); A read once, Q read once, C written once
    b_ms, b_by = bound_ms(4.0 * (nm * km + 2 * km * SPECTRAL_BLOCK),
                          1.0 * nm * km * SPECTRAL_BLOCK)
    results["matmul"] = {
        "max_abs_err": err_mm, "bound_ms": b_ms, "bound_by": b_by,
        "shape": [nm, km, SPECTRAL_BLOCK],
        "square_1024_max_abs_err": float((got_sq - want_sq).abs().max()),
        "f64_max_abs_err": float((got_64 - want_64).abs().max()),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        **timings(lambda: matmul(a_rrg, q8), ["matmul_kernel"],
                  lambda: matmul_ref(a_rrg, q8),
                  lambda: torch.matmul(a_rrg, q8), 50),
    }
    sq_ms, _ = device_ms(lambda: matmul(sq[0], sq[1]), 10, ["matmul_kernel"])
    results["matmul"]["square_1024_ms"] = sq_ms
    # the expansion path's shape: the 792-switch adjacency @ an 8-wide block
    a792 = torch.from_numpy(
        jellyfish(EXP_SWITCHES + EXP_STEPS * EXP_STEP_SWITCHES, EXP_PORTS,
                  EXP_NET, seed=0).adjacency()).to(dev)
    q792 = q8[: a792.shape[0]].contiguous()
    torch.testing.assert_close(matmul(a792, q792), matmul_ref(a792, q792),
                               rtol=1e-5, atol=1e-5)
    n792 = a792.shape[0]
    b_ms792, b_by792 = bound_ms(
        4.0 * (n792 * n792 + 2 * n792 * SPECTRAL_BLOCK),
        1.0 * n792 * n792 * SPECTRAL_BLOCK)
    results["matmul_792"] = {
        "shape": [n792, n792, SPECTRAL_BLOCK], "bound_ms": b_ms792,
        "bound_by": b_by792,
        **timings(lambda: matmul(a792, q792), ["matmul_kernel"],
                  lambda: matmul_ref(a792, q792),
                  lambda: torch.matmul(a792, q792), 50),
    }
    del got, want, sq, got_sq, want_sq, f64, got_64, want_64, a792, q792
    emit({"phase": "kernel_checks", "results": results})

    # ---- 3. APSP of RRG(8192, 48, 36) on the card -------------------------- #
    launches = {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = ops.apsp_minplus_blocked(adj, device=dev)
    apsp_s = time.perf_counter() - t0
    launches["apsp"] = kernels.launch_counts()
    t0 = time.perf_counter()
    want = apsp_hops_blocked(adj)
    bfs_s = time.perf_counter() - t0
    check(np.array_equal(dist, want), "RRG(8192) min-plus APSP != host BFS")
    dfull = torch.from_numpy(dist.astype(np.float32)).to(dev)
    sq_ms, sq_timer = device_ms(lambda: minplus(dfull, dfull), 3,
                                ["minplus_kernel"])
    sq_call_ms = sync_time(lambda: minplus(dfull, dfull), 3)
    # the plain version once at this size: 8192 one-column strips
    sq_plain_ms, sq_plain_timer = device_ms(lambda: minplus_ref(dfull, dfull),
                                            1)
    nn = dfull.shape[0]
    sq_bound, sq_by = bound_ms(4.0 * 3 * nn * nn, 2.0 * nn ** 3)
    emit({"phase": "apsp", "n": nn, "seconds": apsp_s,
          "host_bfs_seconds": bfs_s, "diameter": int(dist.max()),
          "squaring_ms": sq_ms, "squaring_timer": sq_timer,
          "squaring_call_ms": sq_call_ms,
          "squaring_plain_ms": sq_plain_ms,
          "squaring_plain_timer": sq_plain_timer,
          "squaring_bound_ms": sq_bound,
          "squaring_bound_by": sq_by, "equal_to_bfs": True,
          "launches": launches["apsp"]})
    del dfull, dist, want
    torch.cuda.empty_cache()

    # ---- 3'. spectral: lambda_2 of the same RRG by power iteration --------- #
    v0 = np.random.default_rng(1).standard_normal(
        (adj.shape[0], SPECTRAL_BLOCK)).astype(np.float32)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam_gpu = ops.power_iteration_lambda2(adj, iters=SPECTRAL_ITERS,
                                          block=SPECTRAL_BLOCK, v0=v0,
                                          device=dev)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    launches["spectral"] = kernels.launch_counts()
    check(launches["spectral"]["matmul"] == SPECTRAL_ITERS + 1,
          f"spectral path launched matmul {launches['spectral']['matmul']} "
          f"times, expected {SPECTRAL_ITERS + 1}")
    t0 = time.perf_counter()
    lam_cpu = ops.power_iteration_lambda2(adj, iters=SPECTRAL_ITERS,
                                          block=SPECTRAL_BLOCK, v0=v0,
                                          device="cpu")
    spec_cpu_s = time.perf_counter() - t0
    check(abs(lam_gpu - lam_cpu) <= 1e-4 * abs(lam_cpu),
          f"lambda_2 on the card {lam_gpu} != CPU {lam_cpu} (rtol 1e-4)")
    e = rrg.edges
    a_sp = sparse.coo_matrix(
        (np.ones(2 * len(e)), (np.r_[e[:, 0], e[:, 1]], np.r_[e[:, 1], e[:, 0]])),
        shape=adj.shape).tocsr()
    lap = sparse.diags(np.asarray(a_sp.sum(axis=1)).ravel()) - a_sp
    t0 = time.perf_counter()
    lam_true = float(np.sort(eigsh(lap, k=2, which="SA", tol=1e-10,
                                   return_eigenvectors=False))[1])
    eigsh_s = time.perf_counter() - t0
    check(lam_gpu >= lam_true * (1 - 1e-4),
          f"power-iteration lambda_2 {lam_gpu} below eigsh's {lam_true}")
    # the loop's other large step: QR of the 8192 x 8 block, per call
    vq = torch.from_numpy(v0).to(dev)
    qr_ms = sync_time(lambda: torch.linalg.qr(vq), 50)
    emit({"phase": "spectral", "n": adj.shape[0], "iters": SPECTRAL_ITERS,
          "block": SPECTRAL_BLOCK, "lambda2": lam_gpu,
          "lambda2_cpu": lam_cpu, "lambda2_eigsh": lam_true,
          "rel_gap_above_eigsh": (lam_gpu - lam_true) / lam_true,
          "rel_diff_cpu": abs(lam_gpu - lam_cpu) / abs(lam_cpu),
          "seconds": spec_s, "cpu_seconds": spec_cpu_s,
          "eigsh_seconds": eigsh_s, "qr_call_ms": qr_ms,
          "matmul_kernel_ms_total": results["matmul"]["ms"]
          * launches["spectral"]["matmul"],
          "launches": launches["spectral"]})
    del adj, a_rrg, q8, vq, a_sp, lap
    torch.cuda.empty_cache()

    # ---- 4. the full-width probe, and one sequential solve ----------------- #
    # Each path runs with every launch count set to 0 just before it and
    # read just after it.
    clear_routing_cache()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe = capacity.probe_full_capacity(top, n_matrices=3, k=8, iters=500,
                                         method="auto", device=dev)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches["probe"] = kernels.launch_counts()
    systems, res = probe.mw_systems, probe.mw_results
    check(len(res) == 3, f"{3 - len(res)} probe matrices left the MW solver")
    check(all(x.method == "mw-batch-dense" for x in res),
          f"probe did not take the dense kernel: {[x.method for x in res]}")
    check(all(np.isfinite(x.alpha) and 0 < x.alpha < 8 for x in res),
          "probe alphas are not finite")
    check(all(x.rates.shape == (ps.n_paths,) and np.all(np.isfinite(x.rates))
              for x, ps in zip(res, systems)), "probe rates malformed")
    check(probe.verdict == all(x.alpha >= 1.0 - 1e-6 for x in res),
          "probe verdict disagrees with its alphas")

    clear_routing_cache()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_alpha = capacity.alpha_of(top, seed=0, k=8, slack=3, method="mw",
                                  iters=500, device=dev)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    launches["alpha_of"] = kernels.launch_counts()
    if res[0].iters == 500:  # no target stop: the same 500 steps
        check(seq_alpha == res[0].alpha,
              "sequential dense solve differs from its batched member")

    # the probe's solve alone, dense then gather, on the probe's own systems
    solve_s = {}
    alphas = {}
    for be in ("dense", "gather"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alphas[be] = capacity.batch_alphas(systems, method="mw", iters=500,
                                           mw_backend=be, target_alpha=1.0,
                                           device=dev)
        torch.cuda.synchronize()
        solve_s[be] = time.perf_counter() - t0
    check(alphas["dense"] == [x.alpha for x in res],
          "the probe's dense solve is not reproducible")
    diff = max(abs(x - y) for x, y in zip(alphas["dense"], alphas["gather"]))
    check(diff <= 1e-3, f"dense vs gather alpha differ by {diff}")
    for s, ps in enumerate(systems):
        cpu_ps = build_path_system(top, random_permutation_traffic(top, seed=s),
                                   k=8, max_slack=3, device="cpu",
                                   cache=False)
        for f in ("path_edges", "path_len", "path_owner", "demands",
                  "capacities"):
            check(np.array_equal(getattr(ps, f), getattr(cpu_ps, f)),
                  f"matrix {s}: {f} built on the card differs from the CPU")
        check_path_system(ps, top, name=f"probe matrix {s}")
    emit({"phase": "probe", "switches": n_sw, "ports": ports,
          "servers": PROBE_SERVERS,
          "paths": [ps.n_paths for ps in systems],
          "slots": [ps.n_slots for ps in systems],
          "commodities": [ps.n_commodities for ps in systems],
          "alpha": [x.alpha for x in res], "iters": [x.iters for x in res],
          "verdict": probe.verdict, "seconds": probe_s,
          "dense_solve_seconds": solve_s["dense"],
          "gather_solve_seconds": solve_s["gather"],
          "gather_alpha": alphas["gather"], "max_alpha_diff": diff,
          "launches": launches["probe"]})
    emit({"phase": "alpha_of", "method": "mw", "alpha": seq_alpha,
          "seconds": seq_s, "launches": launches["alpha_of"]})

    # ---- 4'. incremental expansion and failures with delta routing -------- #
    def same_system(a, b, what: str) -> None:
        """A delta update equals the rebuild: path sets, slot tables, row
        order and the unrouted set (the slot matrix up to its padding)."""
        w = max(a.path_edges.shape[1], b.path_edges.shape[1])
        pads = [np.pad(x.path_edges, ((0, 0), (0, w - x.path_edges.shape[1])),
                       constant_values=2 * x.n_edges) for x in (a, b)]
        check(a.n_edges == b.n_edges and a.n_commodities == b.n_commodities,
              f"{what}: delta and rebuild differ in size")
        check(np.array_equal(pads[0], pads[1]),
              f"{what}: delta path slots differ from the rebuild")
        for f in ("path_len", "path_owner", "unrouted", "demands", "src",
                  "dst"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{what}: delta {f} differs from the rebuild")

    certified = []
    plain_exact = routing._dist_is_exact

    def recording_exact(d, nbr):
        ok = plain_exact(d, nbr)
        certified.append(bool(ok))
        return ok

    exp_iters, warm_iters = 400, 160
    routing._dist_is_exact = recording_exact
    try:
        clear_routing_cache()
        rebuilds0 = obs.counter("route/update/rebuilds").to_value()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t_exp = time.perf_counter()
        cur = jellyfish(EXP_SWITCHES, EXP_PORTS, EXP_NET, seed=0)
        perm = random_server_permutation(cur.n_servers, seed=0)
        comm = permutation_commodities(cur, perm)
        ps = build_path_system(cur, comm, k=8, device=dev)
        prev = mw_concurrent_flow(ps, iters=exp_iters, device=dev)
        erng = np.random.default_rng(1)
        steps = []
        for step in range(EXP_STEPS + 1):
            if step < EXP_STEPS:
                new = expand_to(cur, cur.n_switches + EXP_STEP_SWITCHES,
                                EXP_PORTS, EXP_NET, seed=erng)
                perm = extend_server_permutation(perm, new.n_servers,
                                                 seed=erng)
                comm = permutation_commodities(new, perm)
                what = f"expansion step {step + 1}"
            else:
                new = fail_links(cur, EXP_FAIL_FRACTION, seed=erng)
                what = f"{EXP_FAIL_FRACTION:.0%} link failures"
            n_cert = len(certified)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps_new = update_path_system(ps, cur, new, comm, device=dev)
            delta_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            full = build_path_system(new, comm, k=8, cache=False, device=dev)
            rebuild_s = time.perf_counter() - t0
            same_system(ps_new, full, what)
            check_path_system(ps_new, new, name=what)
            t0 = time.perf_counter()
            warm = mw_concurrent_flow(ps_new, iters=warm_iters, warm=prev,
                                      device=dev)
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cold = mw_concurrent_flow(ps_new, iters=exp_iters, device=dev)
            cold_s = time.perf_counter() - t0
            loads = ps_new.loads(warm.rates)
            check(bool(np.all(loads <= ps_new.capacities * (1 + 1e-4))),
                  f"{what}: the warm-started flow is infeasible")
            check(np.isfinite(warm.alpha) and np.isfinite(cold.alpha)
                  and warm.alpha >= 0.9 * cold.alpha,
                  f"{what}: warm alpha {warm.alpha} vs cold {cold.alpha}")
            t0 = time.perf_counter()
            lam = ops.power_iteration_lambda2(new.adjacency(),
                                              iters=SPECTRAL_ITERS,
                                              block=SPECTRAL_BLOCK, seed=step,
                                              device=dev)
            lam_s = time.perf_counter() - t0
            steps.append({
                "what": what, "switches": new.n_switches,
                "links": new.n_edges,
                "added": len(new.meta["edges_added"]),
                "removed": len(new.meta["edges_removed"]),
                "commodities": ps_new.n_commodities,
                "paths": ps_new.n_paths, "slots": ps_new.n_slots,
                "reused_rows": int((ps_new.row_map >= 0).sum()),
                "certified": certified[n_cert:],
                "delta_seconds": delta_s, "rebuild_seconds": rebuild_s,
                "warm_alpha": warm.alpha, "warm_iters": warm.iters,
                "warm_seconds": warm_s, "cold_alpha": cold.alpha,
                "cold_iters": cold.iters, "cold_seconds": cold_s,
                "method": cold.method, "lambda2": lam,
                "lambda2_seconds": lam_s})
            ps, cur, prev = ps_new, new, cold
        torch.cuda.synchronize()
        exp_s = time.perf_counter() - t_exp
        launches["expansion"] = kernels.launch_counts()
        rebuilds = obs.counter("route/update/rebuilds").to_value() - rebuilds0
    finally:
        routing._dist_is_exact = plain_exact
    check(rebuilds == 0, f"{rebuilds} delta updates fell back to a rebuild")
    check(len(certified) == len(steps),
          "a delta update skipped the APSP repair and its certificate")
    emit({"phase": "expansion", "start_switches": EXP_SWITCHES,
          "ports": EXP_PORTS, "net_degree": EXP_NET, "k": 8,
          "final_switches": cur.n_switches, "seconds": exp_s,
          "steps": steps, "launches": launches["expansion"]})

    # ---- 5. the bisection -------------------------------------------------- #
    elapsed = time.perf_counter() - t_start
    k_bis = K_FULL if elapsed + 16 * probe_s < TIME_BUDGET_S else 16
    eq_b = fattree_equipment(k_bis)
    lo, hi = eq_b["servers"] // 2, 2 * eq_b["servers"]
    clear_routing_cache()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = capacity.max_servers_at_full_capacity(
        eq_b["switches"], eq_b["ports_per_switch"], lo=lo, hi=hi,
        seeds=(0,), method="mw", device=dev)
    torch.cuda.synchronize()
    bis_s = time.perf_counter() - t0
    launches["bisection"] = kernels.launch_counts()
    check(lo <= best <= hi, f"bisection result {best} outside [{lo}, {hi}]")
    # a small bisection on the card must equal the CPU run (exact LP verdicts
    # on path systems that are identical on both devices)
    eq6 = fattree_equipment(6)
    small = dict(lo=eq6["servers"] // 2, hi=2 * eq6["servers"], seeds=(0,))
    small_gpu = capacity.max_servers_at_full_capacity(
        eq6["switches"], eq6["ports_per_switch"], device=dev, **small)
    small_cpu = capacity.max_servers_at_full_capacity(
        eq6["switches"], eq6["ports_per_switch"], device="cpu", **small)
    check(small_gpu == small_cpu, f"k=6 bisection {small_gpu} != CPU {small_cpu}")
    emit({"phase": "bisection", "k": k_bis, "switches": eq_b["switches"],
          "ports": eq_b["ports_per_switch"], "lo": lo, "hi": hi,
          "servers": best, "fattree_servers": eq_b["servers"],
          "ratio": best / eq_b["servers"], "seconds": bis_s,
          "launches": launches["bisection"], "k6_servers_gpu": small_gpu,
          "k6_servers_cpu": small_cpu})

    # ---- 6. kernels -------------------------------------------------------- #
    replaces = {
        "congestion": "src/repro/kernels/congestion.py:78",
        "congestion_batch": "src/repro/kernels/congestion.py:99",
        "minplus": "src/repro/kernels/minplus.py:61",
        "admission": "src/repro/kernels/admission.py:69",
        "matmul": "src/repro/kernels/power.py:50",
    }
    sources = {
        "congestion": "src/repro_torch/kernels/csrc/congestion.cu",
        "congestion_batch": "src/repro_torch/kernels/csrc/congestion.cu",
        "minplus": "src/repro_torch/kernels/csrc/minplus.cu",
        "admission": "src/repro_torch/kernels/csrc/admission.cu",
        "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    }
    # the path that must launch each kernel; the probe and the bisection
    # solve batched only, the expansion path single instances
    expected = {
        "apsp": ("minplus",),
        "spectral": ("matmul",),
        "probe": ("congestion_batch", "minplus", "admission"),
        "alpha_of": ("congestion", "minplus", "admission"),
        "expansion": ("congestion", "minplus", "admission", "matmul"),
        "bisection": ("congestion_batch", "minplus", "admission"),
    }
    for path, names in expected.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} was not launched by the {path} path")
    rows = []
    for name in replaces:
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": sources[name],
                     "replaces": replaces[name],
                     "launches": sum(c[name] for c in launches.values()),
                     "launches_by_path": {p: c[name]
                                          for p, c in launches.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "timer": r["timer"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"kernels": rows})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
