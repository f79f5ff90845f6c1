#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the paper's Fig 1c capacity path, the spectral lambda_2 path, the
incremental-expansion path and the §5 routing paths (batched path-system
builds with the build pipeline, ECMP, fluid MPTCP, the flow-level
simulator with live topology events), the paper's other topology
families, the inter-pod fabric layer (ring embedding, all-to-all
scoring, elastic delta routing) and the model stack's serving path (four
model families prefilling and decoding), its training path (two
models training) and its mesh half (a sharded train step on a one-rank
card mesh, the dry run's full-size cell) at full width on the card, audits
every registered solver entry at the dispatch level on the card and runs
the expand-cluster example there, and prints one JSON line per phase:

1. ``build``   compile the hand-written CUDA kernels from ``csrc/`` (one
               ``nvcc`` per source, started together).
2. ``kernel_checks``  hold every kernel against its plain torch version on
               the card, on inputs at the shapes the main path gives it
               (min-plus and admission exact; congestion, single and
               batched with and without the members' extents, within rtol
               1e-5; each member of a batched call equal to the single call
               on its unpadded incidence bit for bit, and the empty filler
               member's outputs all zero; matmul within rtol 1e-5 at the
               spectral path's 8192 x 8192 x 8, on the narrow kernel at
               N = 1, 8, 16 and K = 8191, at 1024^3 on the tile kernel, and
               float64 within 1e-12 on both, with TF32 off; the batched
               congestion is timed as the solver calls it, over the
               members' extents, with the whole stack's time beside it),
               and time kernel, plain version and, where
               one exists, the one PyTorch library call computing the same
               function (device time per call from ``torch.profiler``, or
               from CUDA events where two profiler sessions record no
               device activity, with the timer named; the wrapper's
               per-call stream time from CUDA events beside it).
               Before them, the card's add-min issue rates
               (``minplus.pair_rate``: DPX ``__viaddmin_s16x2`` and the
               float32 FADD + FMNMX pair), which bound both min-plus forms,
               and the compiler's register and spill report of both.
3. ``apsp``    APSP of a seeded RRG(8192, 48 ports, degree 36) through
               ``apsp_minplus_blocked`` on the card (the driver's form,
               int16) and through ``apsp_minplus`` (the float32 kernel),
               each equal to the host BFS; each form's 8192^3 squaring
               equal to its plain version and timed.
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
   ``build_batch``  the probe's 3 matrices as ONE
               ``build_path_system_batch`` on the card, equal to 3 sequential
               builds byte for byte, both timed in turns; then the probe
               with the build pipeline on (``probe_batched``) and off
               (``probe_sequential``: lazy sequential builds) in turns,
               each with the probe's verdict and alphas.
   ``ecmp``    Table 1: ``ecmp_path_system(n_ways=64)`` on a Jellyfish of
               the k=14 fat-tree's equipment (245 switches x 14 ports, 686
               servers) on the card, equal to the CPU build, with
               ``path_diversity`` for ECMP and 8-shortest paths; the k=14
               fat-tree's ECMP groups equal (k/2)^2 and k/2.
   ``mptcp``   ``mptcp_throughput(iters=1500)`` on the probe's topology
               (k=8) with ``dense`` (the single-incidence congestion kernel)
               and with ``gather`` on the card, mean throughputs within the
               CPU tests' 2e-6; Fig 8's MPTCP / LP optimum >= 0.86 at
               ``tests/test_torch_mptcp.py``'s size.
   ``sim``     the reference's ``ecmp_sim_512`` row: 8 seeds of
               RRG(512, 24, 18), ``steady_poisson(160, rate=24, size=48)``,
               ``SimConfig(max_flows=2048, max_arrivals=32, wf_iters=10)``,
               ONE batched ``simulate`` per policy (``ecmp`` over ECMP path
               systems, ``ksp_lc`` and ``mptcp`` over k=8; the fan-in
               kernel, ``auto``'s loads-only choice); CT-sim on each, a
               same-seed rerun equal bit for bit, ``waterfill_rates`` dense
               against gather within rtol 1e-5, and ECMP's steady
               throughput dense against gather within rtol 1e-3.  The rerun
               is traced (``torch.profiler``, device activity): the loads
               kernels' device seconds and the device's idle share of its
               window.  The loads half at the k=8 stack's shape: the fan-in
               kernel held bit for bit against its plain version, the dense
               kernel against its own (rtol 1e-5), each timed with CUDA
               events (the fan-in kernel also by the profiler) beside both
               plain versions, one ``torch.bmm``, ``torch.sparse.mm`` over
               each member's CSR transpose and ``portbench/roofline.py``'s
               bound.
5. ``bisection``  a whole ``max_servers_at_full_capacity`` search with
               ``method="mw"`` at the k=24 equipment (k=16 when the probe
               shows it would not fit the time budget; ``k_reason`` says
               which), plus a small bisection whose count must equal the
               CPU run's.
   ``bisection_pipeline``  the same search speculatively
               (``wave_levels=2``, its build units through
               ``stream_builds``) with the build pipeline on and off, each
               equal to the sequential search's count, with
               ``pipeline/stall_s`` and ``pipeline/overlap_s``; when the
               budget is short this pair drops to k=16 (against a
               sequential search there) before the search above does.
   ``events``  live topology events (§4.3) at the ``sim`` instance, cut
               to its first seed (``EVENTS_SEEDS``), with
               the CT checks on: for ``ksp_lc`` and ``ecmp``,
               ``simulate_events`` with an empty schedule and with
               ``max_seg=40`` equal to ``simulate`` bit for bit, then links
               failed (5 %) at step 40, healed at 80 and 16 switches added at
               120: volume conserved, the carry contract held at every
               boundary, the migrations (survived, reselected, killed), the
               reroute seconds per boundary and each segment's backend and
               step ms; an MTBF 40 / MTTR 20 failure schedule on ``ecmp``;
               and the schedule at 2 x RRG(64, 10, 6), 48 steps, on the card
               (``dense``) against the CPU (``gather``) from one CPU-drawn
               stream: equal migrations, accumulators within 1e-3.
   ``families``  Fig 3 at full size (SWDC ring, 2D torus, 3D hex torus
               and Jellyfish on 484 switches of 8 ports, 2 servers each),
               Fig 12 (12 pods x 12 switches, r = 8 of 10 ports, 0 and 5
               links local, with ``plan_cables``) and Fig 2's degree-diameter
               cases: each topology equal to the CPU build by fingerprint,
               each alpha by ``capacity.alpha_of`` with MW on ``dense`` (the
               single congestion kernel), Fig 3's also on ``gather`` within
               5e-3; the Jellyfish / best-SWDC ratio (printed, not checked).
   ``fabric``  ``benchmarks/fabric_scale.py``'s configuration through the
               fabric layer (``repro_torch.fabric``), timed with
               ``obs.Timer(device=...)``: ring embeddings of Jellyfish
               fabrics (degree 8) at 16, 64, 256 and 1024 pods, each also
               after 10 % of its links fail, and of fat-trees up to 256
               pods, each equal to the CPU's (host BFS, numpy admission);
               20 48-port switches joining a 100-switch 24-port Jellyfish
               (mean path before and after, ``validate``); at 1024 pods the
               elastic chain ``path_system`` -> ``fail(0.1)`` ->
               ``expand(64)`` -> ``remove(7)``, each delta equal to a
               rebuild on the card field by field; ``a2a_efficiency`` at 256
               and 1024 pods equal to the CPU's, the 1024-pod runs split
               into hop matrix, enumeration and the Python usage loop.
               Under 60 s.
   ``obs``     ``python -m repro_torch.obs smoke --device cuda`` in-process:
               a traced MW solve bit-identical to an untraced one.
   ``serve``   the model stack's serving path (``repro_torch.models``,
               ``launch.serve``), eager PyTorch, none of the kernels below:
               every registered arch at ``reduced()`` in float32, the same
               weights on the card and on the CPU (prefill logits, every
               cache tensor, 10 greedy decode steps, a 24-token prompt
               wrapping the 16-slot windows); then ``rwkv6-1.6b`` (serve's
               default), ``minitron-8b``, ``qwen2-moe-a2.7b`` and
               ``recurrentgemma-2b`` at full width in bf16, batch 4, prompt
               32, 16 new tokens through ``serve.generate``: parameters,
               peak memory, prefill ms, decode ms a token beside its HBM
               bound, decode against a fresh prefill for 3 steps, one decode
               step traced (device-busy share, launches, top five ops);
               ``rwkv6-1.6b`` also in f32 on the card against f32 and f64 on
               the CPU, and bf16 against f32 per layer and at the logits.
               Under 90 s.
   ``train``   the model stack's training path (``launch.steps``,
               ``launch.train``, ``optim``, ``runtime.fault``), eager
               PyTorch: every registered arch at ``reduced()`` in float32,
               one ``make_train_step`` step from the same weights and batch
               on the card and on the CPU (loss, global gradient norm,
               parameters, ``mu`` and ``nu`` within the CPU tests' bounds);
               on the card ``microbatches=2`` against 1 (the reference's
               bounds), 8 steps with int8 error feedback (the loss falls),
               ``remat`` none / full / dots giving the same gradients, and
               the fault-tolerant loop (a crash at step 15 with checkpoints
               every 5 ends bit for bit where an uninterrupted run ends; a
               NaN batch skipped leaves the state bit for bit); then
               ``rwkv6-1.6b`` and ``internvl2-1b`` at full width through
               ``launch.train.main`` (bf16, batch 8, sequence 128,
               ``remat="full"``, 12 steps, no checkpoint in the window: the
               loss finite and falling), step 1's bf16 loss and gradient
               norm against an f32 twin of the same weights, the step timed
               (forward, backward, optimizer), tokens/s, peak memory, the
               model-FLOP utilization (6 N tokens / step time over the bf16
               peak), two identical steps from one state compared bit for
               bit, and one step traced.  The train steps launch none of
               the kernels; the fabric tie's launches are the ``train``
               path's.  Under 90 s.
   ``mesh``    the model stack's mesh half (``launch.mesh``,
               ``runtime.sharding``, the sharded steps of ``launch.steps``,
               ``launch.dryrun``): ``internvl2-1b`` at full width (bf16,
               batch 8, sequence 128) trains two steps on
               ``make_local_mesh()`` over the card (an NCCL mesh of one
               rank) and two with ``mesh=None`` from the same state, equal
               bit for bit (parameters, ``mu``, ``nu``, losses); both timed
               (best of 3), the sharded step's peak memory and kernel
               launches (none); one reduced arch per family (dense, MoE,
               RWKV-6, RG-LRU hybrid) sharded on the same mesh: a train step
               against the CPU step under the train phase's gates, a prefill
               and a decode step (caches placed by ``cache_shardings``)
               against ``mesh=None`` under the serve phase's bounds.  Two
               checks run on the host's CPU beside the earlier phases, in
               processes that do not see the card: four gloo
               ranks at (2, 2) (a reduced dense arch's loss, gradients and
               one AdamW step against the unsharded port; named a CPU check)
               and the dry run's ``qwen2.5-32b x train_4k x pod16x16`` cell
               (a fake group of 256 ranks, fake tensors), without and with
               int8 error feedback, whose per-rank argument and peak bytes
               are held against the card's memory and whose roofline terms
               are printed.  Under 60 s.
   ``ir``      the dispatch-level audit (``repro_torch.analysis.irlint``,
               JF100-JF105 less the CPU-only budgets) on the card over every
               registered case: no finding beyond the recorded exemptions,
               every kernel, wrapper and dense solver case moving the launch
               counters it names, each case's aten ops and launches
               printed; then RT-1 (``analysis.retrace``): one MW batch run a
               second time builds no kernel and equals the first run.
   ``examples``  ``examples/expand_cluster_torch.py`` at its own sizes (64
               -> 80 pods in 4-pod tranches with MW at 200 iterations, 5 %
               of the links failed, a pod lost) on the card, against a CPU
               run of the same code: descriptions, path systems (by
               digest), spliced shares, ring, mesh re-plans and the restore
               equal, MW alphas within ``EXAMPLE_ALPHA_RTOL``.  The two
               phases aim under 30 s together.
6. ``time``    the script's seconds so far beside its aim.
   ``kernels`` per kernel: launches on each path (``apsp``, ``apsp_f32``,
               ``spectral``, the probe,
               ``alpha_of``, ``expansion``, ``build_batch``,
               ``probe_sequential``, ``ecmp``, ``mptcp``, ``sim``, the
               bisection and both wave bisections, ``events``,
               ``families``, ``fabric``, ``train``, ``ir``, ``examples``,
               each run with
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

import atexit
import json
import math
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
#: A min-plus (i, j, k) pair in float32 is two of those instructions (FADD,
#: FMNMX); the DPX rate of the int16 form has no data sheet and is measured.
FP32_PAIRS_PER_S = FP32_INSTR_PER_S / 2

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
#: Seeds of the events phase: the sim instance's first of its 8 seeds, cut
#: so that the serve and train phases fit the budget.
EVENTS_SEEDS = 1


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


def minplus_bound_ms(n_bytes: float, n_pairs: float,
                     dpx_pairs_per_s: float) -> dict:
    """The least time for a min-plus product of ``n_pairs`` (i, j, k) pairs
    over the ways the card offers: float32 (two instructions a pair at the
    data sheet's issue rate) or DPX (at the measured pair rate); both forms
    are bounded by the same pairs.  Bytes: the form's own operands read once
    and its output written once."""
    t_fp32 = n_pairs / FP32_PAIRS_PER_S * 1e3
    t_dpx = n_pairs / dpx_pairs_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(t_fp32, t_dpx)
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_bound_ms": t_fp32, "dpx_bound_ms": t_dpx}


def ptxas_report(log: str, names) -> dict:
    """Registers, spills and shared memory per kernel entry from
    ``nvcc -Xptxas -v`` output, for the entries whose name holds one of
    ``names``."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            cur = entry if any(n in entry for n in names) else None
            if cur:
                out[cur] = []
        elif cur and ("Used" in line or "spill" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


# --------------------------------------------------------------------------- #
# the §5 routing paths (each a function, so a small CPU run can rehearse it)
# --------------------------------------------------------------------------- #

#: Fields that must match byte for byte between two builds of one system.
SYSTEM_FIELDS = ("path_edges", "path_len", "path_owner", "demands", "src",
                 "dst", "unrouted")
#: The CPU tests' port-vs-reference bound on MPTCP per-commodity throughput
#: (tests/test_torch_mptcp.py), held here to dense against gather.
MPTCP_ATOL = 2e-6
#: ECMP's path choice ignores loads, so dense and gather runs admit the same
#: flows onto the same paths; their steady-state throughputs may differ by
#: the dense product's rounding and any completion that it moves by a step.
SIM_ECMP_RTOL = 1e-3


def same_system(a, b, what: str) -> None:
    """Two builds of one path system are equal byte for byte."""
    import numpy as np

    check(a.n_edges == b.n_edges and a.n_commodities == b.n_commodities,
          f"{what}: sizes differ")
    for f in SYSTEM_FIELDS:
        check(np.array_equal(np.asarray(getattr(a, f)),
                             np.asarray(getattr(b, f))),
              f"{what}: {f} differs")


class PathRun:
    """Runs a path with every launch count set to 0 just before it and read
    just after it, timing it on the host clock (synchronized on a card)."""

    def __init__(self, dev, launches: dict):
        self.dev = dev
        self.launches = launches

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def __call__(self, name: str, fn):
        from repro_torch import kernels

        kernels.reset_launch_counts()
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        secs = time.perf_counter() - t0
        self.launches[name] = kernels.launch_counts()
        return out, secs


def build_batch_phase(top, run: PathRun, n_matrices: int = 3,
                      k: int = 8) -> dict:
    """The probe's matrices as ONE ``build_path_system_batch`` on the card,
    equal to the sequential builds byte for byte; both timed in turns
    (batch, sequential, sequential, batch), each from a cleared cache."""
    from repro_torch.core import (
        build_path_system,
        build_path_system_batch,
        random_permutation_traffic,
    )
    from repro_torch.core.routing import clear_routing_cache

    comms = [random_permutation_traffic(top, seed=s)
             for s in range(n_matrices)]

    def batch():
        return build_path_system_batch([top] * n_matrices, comms, k=k,
                                       max_slack=3, device=run.dev).systems

    def sequential():
        return [build_path_system(top, c, k=k, max_slack=3, device=run.dev)
                for c in comms]

    secs = {"batch": [], "sequential": []}
    built = {}
    for tag in ("batch", "sequential", "sequential", "batch"):
        clear_routing_cache()
        fn = batch if tag == "batch" else sequential
        if tag == "batch" and not secs["batch"]:
            built[tag], t = run("build_batch", fn)
        else:
            run.sync()
            t0 = time.perf_counter()
            built[tag] = fn()
            run.sync()
            t = time.perf_counter() - t0
        secs[tag].append(t)
    for i, (a, b) in enumerate(zip(built["batch"], built["sequential"])):
        same_system(a, b, f"batch build, matrix {i}")
    return {"phase": "build_batch", "switches": top.n_switches,
            "servers": int(top.n_servers), "matrices": n_matrices, "k": k,
            "paths": [ps.n_paths for ps in built["batch"]],
            "batch_seconds": secs["batch"],
            "sequential_seconds": secs["sequential"],
            "equal_to_sequential": True,
            "launches": run.launches["build_batch"]}


def ecmp_phase(run: PathRun, switches: int = 245, ports: int = 14,
               servers: int = 686, ft_k: int = 14, n_ways: int = 64) -> dict:
    """Table 1: ECMP against 8-shortest paths on a Jellyfish of the k = 14
    fat-tree's equipment (ECMP on the card equal to the CPU build), and the
    fat-tree's own ECMP groups against the analytic counts."""
    import numpy as np

    from repro_torch import capacity
    from repro_torch.core import (
        build_path_system,
        ecmp_path_system,
        fattree,
        random_permutation_traffic,
    )
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.sim import fattree_ecmp_check, path_diversity

    top = capacity.jellyfish_same_equipment(switches, ports, servers, seed=0)
    comm = random_permutation_traffic(top, seed=0)
    clear_routing_cache()
    eps, ecmp_s = run("ecmp", lambda: ecmp_path_system(
        top, comm, n_ways=n_ways, device=run.dev))
    clear_routing_cache()
    same_system(eps, ecmp_path_system(top, comm, n_ways=n_ways, device="cpu",
                                      cache=False), "ECMP on the card vs CPU")
    ksp = build_path_system(top, comm, k=8, device=run.dev)

    def diversity(ps):
        d = path_diversity(ps)
        per_link = d["paths_per_link_ranked"]
        return {"links_total": d["links_total"],
                "links_covered": d["links_covered"],
                "coverage": d["coverage"],
                "mean_paths_per_commodity": d["mean_paths_per_commodity"],
                "paths_per_link_median": float(np.median(per_link)),
                "links_with_at_most_2_paths": int((per_link <= 2).sum())}

    ft = fattree(ft_k)
    feps = ecmp_path_system(ft, random_permutation_traffic(ft, seed=0),
                            n_ways=n_ways, device=run.dev)
    chk = fattree_ecmp_check(feps, ft_k)
    check(chk["inter_pod_groups_exact"] and chk["same_pod_groups_exact"],
          f"fat-tree k={ft_k} ECMP groups {chk['inter_pod_groups']} / "
          f"{chk['same_pod_groups']} differ from "
          f"{chk['expected_inter_pod']} / {chk['expected_same_pod']}")
    return {"phase": "ecmp", "switches": switches, "ports": ports,
            "servers": servers, "n_ways": n_ways, "seconds": ecmp_s,
            "equal_to_cpu": True, "ecmp": diversity(eps),
            "ksp8": diversity(ksp),
            "fattree": {"k": ft_k,
                        "inter_pod_groups": chk["inter_pod_groups"].tolist(),
                        "same_pod_groups": chk["same_pod_groups"].tolist(),
                        "expected_inter_pod": chk["expected_inter_pod"]},
            "launches": run.launches["ecmp"]}


def mptcp_phase(top, run: PathRun, iters: int = 1500) -> dict:
    """Fluid MPTCP on the probe's topology, dense (the congestion kernel)
    against gather on the card, and Fig 8's claim at the CPU test's size."""
    import numpy as np

    from repro_torch.core import (
        build_path_system,
        jellyfish,
        lp_concurrent_flow,
        mptcp_throughput,
        random_permutation_traffic,
    )
    from repro_torch.core.routing import clear_routing_cache

    comm = random_permutation_traffic(top, seed=0)
    clear_routing_cache()

    def path():
        ps = build_path_system(top, comm, k=8, device=run.dev)
        return ps, mptcp_throughput(ps, iters=iters, backend="dense",
                                    device=run.dev)

    (ps, dense), dense_s = run("mptcp", path)
    run.sync()
    t0 = time.perf_counter()
    gather = mptcp_throughput(ps, iters=iters, backend="gather",
                              device=run.dev)
    run.sync()
    gather_s = time.perf_counter() - t0
    gap = abs(dense.mean_throughput - gather.mean_throughput)
    check(gap <= MPTCP_ATOL, f"MPTCP mean throughput dense "
          f"{dense.mean_throughput} vs gather {gather.mean_throughput}")
    check(bool(np.all(ps.loads(dense.rates) <= ps.capacities * (1 + 1e-5))),
          "MPTCP rates overload a link")
    # Fig 8 at tests/test_torch_mptcp.py's size
    top8 = jellyfish(60, 10, 7, seed=5)
    comm8 = random_permutation_traffic(top8, seed=6)
    opt = lp_concurrent_flow(build_path_system(top8, comm8, k=24, max_slack=4,
                                               device=run.dev))
    mp8 = mptcp_throughput(build_path_system(top8, comm8, k=8,
                                             device=run.dev),
                           iters=iters, device=run.dev)
    frac = mp8.mean_throughput / max(opt.normalized_throughput(), 1e-9)
    check(frac >= 0.86, f"Fig 8: MPTCP / optimal = {frac} < 0.86")
    return {"phase": "mptcp", "switches": top.n_switches,
            "servers": int(top.n_servers), "paths": ps.n_paths,
            "slots": ps.n_slots, "iters": iters,
            "mean_throughput": dense.mean_throughput,
            "jain": dense.jain_index,
            "gather_mean_throughput": gather.mean_throughput,
            "mean_gap": gap, "per_flow_max_gap": float(
                np.abs(dense.per_flow - gather.per_flow).max()),
            "seconds": dense_s, "gather_seconds": gather_s,
            "fig8_fraction_of_optimal": frac,
            "launches": run.launches["mptcp"]}


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn()`` between two CUDA events, after
    one call to warm it."""
    import torch

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


#: The loads kernels a traced ``simulate`` may run: the fan-in kernel
#: (``auto``) or the dense congestion kernel's band and fold passes.
LOADS_KERNELS = ("fan_in_kernel", "congestion_band_kernel",
                 "congestion_fold_kernel")


def sim_trace(prof, window_s: float, untraced_s: float) -> dict:
    """From a device-activity trace of one ``simulate``: the loads
    kernels' device seconds (``LOADS_KERNELS``) and launches (a fold
    pass is no launch of its own), every device operation's seconds
    (runtime API entries excluded; one stream, so they do not overlap), and
    their shares of the traced host window.  ``untraced_s`` is the same
    run's seconds without the profiler, beside it for the tracer's cost."""
    cong_s = busy_s = 0.0
    cong_n = 0
    for ev in prof.key_averages():
        if ev.key.startswith("cuda"):
            continue
        busy_s += ev.device_time_total / 1e6
        if any(k in ev.key for k in LOADS_KERNELS):
            cong_s += ev.device_time_total / 1e6
            if "fold" not in ev.key:
                cong_n += ev.count
    if busy_s == 0.0:
        return {"timer": "not measured: the profiler saw no device activity",
                "window_s": window_s, "untraced_s": untraced_s}
    return {"timer": "profiler", "window_s": window_s,
            "untraced_s": untraced_s, "loads_device_s": cong_s,
            "loads_launches": cong_n, "device_busy_s": busy_s,
            "loads_share_of_window": cong_s / window_s,
            "loads_share_of_untraced": cong_s / untraced_s,
            "device_idle_share_of_window": 1.0 - busy_s / window_s}


def loads_timings(batch, dev) -> dict:
    """The loads-only product over ``batch``'s members at their extents,
    each form timed with CUDA events (milliseconds a call): the fan-in
    kernel (``auto``'s choice, held bit for bit against its plain version,
    also timed by the profiler), its plain version on the card, the dense
    congestion kernel with zero prices (against its plain version) and one
    ``torch.bmm`` over the whole stack, and per member ``torch.sparse.mm``
    over the CSR transpose of its incidence (a yardstick the port never
    calls); beside them ``portbench/roofline.py``'s bound for the work."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.roofline import Work, bound_seconds, call_work
    from repro_torch.core.flow import _stacked_incidence
    from repro_torch.kernels import ops
    from repro_torch.kernels.congestion import congestion_ref
    from repro_torch.kernels.fanin import (
        fan_in_loads,
        fan_in_loads_ref,
        fan_in_table,
    )

    out = {"shape": [batch.n_batch, batch.p_max, batch.s_max],
           "fan_in_d": int(batch.slot_gather.shape[-1]), "timer": "events",
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    L = batch.path_edges.shape[-1]
    ext = (batch.n_paths, [ps.n_slots for ps in batch.systems])
    rates = torch.rand((batch.n_batch, batch.p_max), device=dev)
    for i, p in enumerate(batch.n_paths.tolist()):
        rates[i, p:] = 0.0   # as in the engine: padded rows ship nothing
    tab = fan_in_table(batch.slot_gather, dev)
    fan = fan_in_loads(tab, rates, L, ext[1])
    want = fan_in_loads(tab.cpu(), rates.cpu(), L, ext[1])
    check(torch.equal(fan.cpu().view(torch.int32), want.view(torch.int32)),
          "the fan-in kernel differs from its plain version")
    csr = []
    for i, ps in enumerate(batch.systems):
        t = batch.slot_gather[i, : ps.n_slots]
        keep = t < batch.p_max * L
        crow = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
        csr.append(torch.sparse_csr_tensor(
            torch.from_numpy(crow),
            torch.from_numpy((t[keep] // L).astype(np.int64)),
            torch.ones(int(keep.sum())), (ps.n_slots, batch.p_max)).to(dev))
    sparse = [torch.sparse.mm(c, rates[i, :, None])[:, 0]
              for i, c in enumerate(csr)]
    for i, (s, ps) in enumerate(zip(sparse, batch.systems)):
        torch.testing.assert_close(s, fan[i, : ps.n_slots], rtol=1e-5,
                                   atol=1e-6)
    b3 = _stacked_incidence(torch.as_tensor(batch.path_edges, device=dev),
                            batch.s_max)
    zeros = torch.zeros((batch.n_batch, batch.s_max), device=dev)
    got = ops.congestion_loads(b3, rates, ext)
    torch.testing.assert_close(got, congestion_ref(b3, rates, zeros, ext)[0],
                               rtol=1e-5, atol=1e-6)
    out["dense_vs_fan_in_max_abs"] = float((got - fan).abs().max())
    for name, fn, reps in (
            ("fan_in", lambda: fan_in_loads(tab, rates, L, ext[1]), 200),
            ("plain", lambda: fan_in_loads_ref(tab, rates, L, ext[1]), 20),
            ("dense", lambda: ops.congestion_loads(b3, rates, ext), 20),
            ("plain_dense", lambda: congestion_ref(b3, rates, zeros, ext),
             10),
            # one library call over the whole padded stack (TF32 off)
            ("library_bmm", lambda: torch.bmm(rates[:, None, :], b3), 10),
            ("library_sparse_csr", lambda: [
                torch.sparse.mm(c, rates[i, :, None])
                for i, c in enumerate(csr)], 50)):
        out[name] = events_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            fan_in_loads(tab, rates, L, ext[1])
        torch.cuda.synchronize()
    dev_us = [ev.device_time_total / ev.count for ev in prof.key_averages()
              if "fan_in_kernel" in ev.key and ev.count]
    out["fan_in_device"] = dev_us[0] / 1e3 if dev_us else \
        "not measured: the profiler saw no device activity"
    work = Work()
    for ps in batch.systems:
        work.add(call_work(int(np.asarray(ps.path_len).sum()), ps.n_paths,
                           ps.n_slots, fused=False))
    out.update({"bound_ms": bound_seconds(work) * 1e3,
                "bound_bytes": work.bytes, "bound_flops": work.flops})
    # the dense kernel's own bound: B read once within the extents
    cells = sum(ps.n_paths * ps.n_slots for ps in batch.systems)
    edges = sum(ps.n_paths + 2 * ps.n_slots for ps in batch.systems)
    out["dense_bound_ms"] = bound_ms(4.0 * (cells + edges), 1.0 * cells)[0]
    del b3, zeros, got, tab, csr
    torch.cuda.empty_cache()
    return out


def sim_phase(run: PathRun, n_seeds: int = 8, n: int = 512, ports: int = 24,
              net: int = 18, steps: int = 160, rate: float = 24.0,
              size: float = 48.0, max_flows: int = 2048,
              max_arrivals: int = 32, wf_iters: int = 10) -> dict:
    """The reference's ``ecmp_sim_512`` row: ``n_seeds`` RRGs in ONE batched
    ``simulate`` per policy (ECMP over ``ecmp_path_system(n_ways=64)``,
    ``ksp_lc`` and ``mptcp`` over k = 8), with CT-sim, same-seed
    determinism, and dense against gather checks."""
    import numpy as np

    from repro_torch.analysis.contracts import check_sim_state
    from repro_torch.core import (
        build_path_system_batch,
        ecmp_path_system,
        jellyfish,
        random_permutation_traffic,
    )
    from repro_torch.core.flow import PathSystemBatch
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.sim import (
        SimConfig,
        fct_percentiles,
        simulate,
        steady_poisson,
        steady_state_throughput,
        waterfill_rates,
    )

    tops = [jellyfish(n, ports, net, seed=s) for s in range(n_seeds)]
    comms = [random_permutation_traffic(t, seed=s) for s, t in enumerate(tops)]
    wl = steady_poisson(steps, rate=rate, size=size)
    cfg = SimConfig(max_flows=max_flows, max_arrivals=max_arrivals,
                    wf_iters=wf_iters)
    clear_routing_cache()
    policies = {}
    results = {}

    def path():
        t0 = time.perf_counter()
        ecmp = PathSystemBatch.from_systems([
            ecmp_path_system(t, c, n_ways=64, device=run.dev)
            for t, c in zip(tops, comms)])
        ksp = build_path_system_batch(tops, comms, k=8, device=run.dev)
        build_s = time.perf_counter() - t0
        for policy, batch in (("ecmp", ecmp), ("ksp_lc", ksp),
                              ("mptcp", ksp)):
            run.sync()
            t0 = time.perf_counter()
            results[policy] = simulate(batch, wl, policy=policy, config=cfg,
                                       seed=0, device=run.dev)
            run.sync()
            policies[policy] = {"seconds": time.perf_counter() - t0}
        return ecmp, ksp, build_s

    (ecmp, ksp, build_s), path_s = run("sim", path)
    for policy, res in results.items():
        check_sim_state(res, name=f"sim {policy}")
        thr = steady_state_throughput(res)
        policies[policy].update({
            "backend": res.backend,
            "paths_per_instance": (ecmp if policy == "ecmp"
                                   else ksp).n_paths.tolist(),
            "steady_throughput": thr.tolist(),
            "steady_throughput_mean": float(thr.mean()),
            "offered_per_step": rate * size,
            "admitted": int(res.admitted.sum()), "drops": int(res.drops.sum()),
            "active_end_mean": float(res.active[-1].mean()),
            "fct_p50_p99_mean": np.nanmean(
                fct_percentiles(res, (0.5, 0.99)), axis=0).tolist(),
            "step_ms": policies[policy]["seconds"] / steps * 1e3})
    # same seed, same run: bit for bit.  On a card the rerun is traced
    # (device activity only) for the congestion kernel's device seconds and
    # every device operation's over the rerun's host window
    trace = {}
    if run.dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run.sync()
            t0 = time.perf_counter()
            again = simulate(ksp, wl, policy="ksp_lc", config=cfg, seed=0,
                             device=run.dev)
            run.sync()
            window = time.perf_counter() - t0
        trace = sim_trace(prof, window, policies["ksp_lc"]["seconds"])
    else:
        again = simulate(ksp, wl, policy="ksp_lc", config=cfg, seed=0,
                         device=run.dev)
    for f in ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
              "comm_delivered", "comm_offered", "util_sum", "drops",
              "admitted", "inflight"):
        check(np.array_equal(getattr(again, f), getattr(results["ksp_lc"], f)),
              f"sim ksp_lc rerun with the same seed: {f} differs")
    # the waterfill alone (no RNG) on the ksp batch: dense against gather
    wf = {be: waterfill_rates(ksp, wf_iters=48, backend=be, device=run.dev)
          for be in ("dense", "gather")}
    for i, what in enumerate(("rates", "loads")):
        got, want = wf["dense"][i], wf["gather"][i]
        check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"waterfill {what}: dense vs gather beyond rtol 1e-5 (max "
              f"{float(np.abs(got - want).max())})")
    # the waterfill's loads half at this path's shape
    loads_t = loads_timings(ksp, run.dev) if run.dev.type == "cuda" else {}
    # ECMP under dense: the same flows, throughput to the stated tolerance
    run.sync()
    t0 = time.perf_counter()
    ed = simulate(ecmp, wl, policy="ecmp", config=cfg, seed=0,
                  backend="dense", device=run.dev)
    run.sync()
    ed_s = time.perf_counter() - t0
    td = steady_state_throughput(ed)
    tg = steady_state_throughput(results["ecmp"])
    rel = float(np.max(np.abs(td - tg) / np.maximum(np.abs(tg), 1e-12)))
    check(rel <= SIM_ECMP_RTOL, f"sim ecmp steady throughput dense vs "
          f"gather differs by {rel} (rtol {SIM_ECMP_RTOL})")
    return {"phase": "sim", "n": n, "ports": ports, "net_degree": net,
            "seeds": n_seeds, "steps": steps, "rate": rate, "size": size,
            "max_flows": max_flows, "max_arrivals": max_arrivals,
            "wf_iters": wf_iters, "build_seconds": build_s,
            "seconds": path_s, "policies": policies,
            "deterministic": True,
            "waterfill_dense_vs_gather_max": [
                float(np.abs(wf["dense"][i] - wf["gather"][i]).max())
                for i in range(2)],
            "ecmp_dense_steady_throughput_mean": float(td.mean()),
            "ecmp_dense_vs_gather_rel": rel, "ecmp_dense_seconds": ed_s,
            "ecmp_dense_step_ms": ed_s / steps * 1e3,
            "loads_ms_per_call": loads_t, "ksp_lc_rerun_trace": trace,
            "launches": run.launches["sim"]}


#: ``SimResult`` accumulators a segmented run must reproduce.
SIM_FIELDS = ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
              "comm_delivered", "comm_offered", "util_sum", "drops",
              "admitted", "blackholed", "blackholed_total", "inflight",
              "demands", "slot_valid")


def event_schedule(steps: int, grow: int = 16) -> list:
    """Links fail (5 %) at a quarter of the horizon, heal at half, and the
    fabric grows by ``grow`` switches at three quarters."""
    from repro_torch.sim import Event

    return [Event(step=steps // 4, kind="fail_links", fraction=0.05, seed=1,
                  tag="f"),
            Event(step=steps // 2, kind="heal_links", heal_of="f"),
            Event(step=3 * steps // 4, kind="expand", grow=grow, seed=2)]


def traced_events_run(run: PathRun, *args, **kw) -> tuple:
    """One ``simulate_events`` with the span tracer on: the run, then its
    reroute seconds per boundary and, per segment, its steps, backend and
    milliseconds a step (host clock, each segment ends in a host read)."""
    from repro_torch import obs
    from repro_torch.sim import simulate_events

    prev = obs.set_trace(True)
    obs.reset_trace()
    try:
        ev = simulate_events(*args, device=run.dev, **kw)
    finally:
        obs.set_trace(prev)
    spans = obs.get_spans()
    reroute = [{"step": sp.attrs["step"], "seconds": sp.wall_s}
               for sp in spans if sp.name == "sim/reroute"]
    segments = [{"t0": sp.attrs["t0"], "steps": sp.attrs["steps"],
                 "backend": sp.attrs["backend"],
                 "step_ms": sp.wall_s / sp.attrs["steps"] * 1e3}
                for sp in spans if sp.name == "sim/segment"]
    return ev, reroute, segments


def migrations(ev) -> list:
    """Each boundary's migration counts, summed over the instances."""
    return [{"step": r["step"], "kinds": r["kinds"],
             **{f: int(r[f].sum()) for f in ("survived", "reselected",
                                             "killed")},
             "blackholed_kills": float(r["blackholed_kills"].sum())}
            for r in ev.events]


def events_phase(run: PathRun, n_seeds: int = 8, n: int = 512,
                 ports: int = 24, net: int = 18, steps: int = 160,
                 rate: float = 24.0, size: float = 48.0,
                 max_flows: int = 2048, max_arrivals: int = 32,
                 wf_iters: int = 10, grow: int = 16,
                 small: tuple = (2, 64, 10, 6, 48)) -> dict:
    """Live topology events (§4.3) at the ``sim`` phase's instance, with the
    CT checks on (CT-sim and the carry-migration contract at every
    boundary): for ``ksp_lc`` and ``ecmp``, an empty schedule and a
    ``max_seg=40`` split equal ``simulate`` bit for bit, and a fail / heal
    / expand schedule conserves volume through three migrations; then an
    MTBF/MTTR schedule (``benchmarks/fig7_resilience.py``'s) on ``ecmp``;
    then the schedule at a reduced size on the card (``dense``) against the
    CPU (``gather``) from one CPU-drawn stream: equal migrations, every
    accumulator within ``SIM_ECMP_RTOL`` of its largest magnitude."""
    import numpy as np

    from repro_torch.analysis.contracts import set_check_enabled
    from repro_torch.core import (
        build_path_system_batch,
        jellyfish,
        random_permutation_traffic,
    )
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.sim import (
        SimConfig,
        draw_arrivals,
        event_summary,
        poisson_failure_schedule,
        simulate,
        simulate_events,
        steady_poisson,
        steady_state_throughput,
    )

    def same_result(a, b, what):
        for f in SIM_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            check(x.shape == y.shape and np.array_equal(x, y),
                  f"{what}: {f} differs from simulate's")
        check(a.backend == b.backend, f"{what}: backend differs")

    def conserved(res, what):
        off = res.comm_offered.sum(axis=1, dtype=np.float64)
        lhs = (res.comm_delivered.sum(axis=1, dtype=np.float64)
               + res.blackholed_total + res.inflight)
        err = float((np.abs(off - lhs) / np.maximum(off, 1.0)).max())
        check(err <= 1e-3, f"{what}: offered != delivered + blackholed + "
              f"in-flight (relative {err})")
        return err

    tops = [jellyfish(n, ports, net, seed=s) for s in range(n_seeds)]
    comms = [random_permutation_traffic(t, seed=s) for s, t in enumerate(tops)]
    wl = steady_poisson(steps, rate=rate, size=size)
    cfg = SimConfig(max_flows=max_flows, max_arrivals=max_arrivals,
                    wf_iters=wf_iters)
    sched = event_schedule(steps, grow)
    mtbf = poisson_failure_schedule(steps, mtbf_steps=40.0, mttr_steps=20.0,
                                    start_step=steps // 6, seed=17)
    out = {"phase": "events", "n": n, "ports": ports, "net_degree": net,
           "seeds": n_seeds, "steps": steps, "rate": rate, "size": size,
           "max_flows": max_flows, "max_arrivals": max_arrivals,
           "wf_iters": wf_iters, "grow": grow,
           "schedule": [[e.step, e.kind] for e in sched], "policies": {}}
    prev_checks = set_check_enabled(True)
    clear_routing_cache()
    try:
        def path():
            systems = build_path_system_batch(tops, comms, k=8,
                                              device=run.dev).systems
            for policy in ("ksp_lc", "ecmp"):
                rec = out["policies"][policy] = {}
                run.sync()
                t0 = time.perf_counter()
                base = simulate(systems, wl, policy=policy, config=cfg,
                                seed=0, device=run.dev)
                rec["simulate_seconds"] = time.perf_counter() - t0
                for max_seg in (0, 40):
                    ev = simulate_events(tops, comms, [], wl,
                                         systems=systems, policy=policy,
                                         config=cfg, seed=0, max_seg=max_seg,
                                         device=run.dev)
                    same_result(ev.result, base,
                                f"{policy} empty schedule, max_seg={max_seg}")
                run.sync()
                t0 = time.perf_counter()
                ev, reroute, segs = traced_events_run(
                    run, tops, comms, sched, wl, systems=systems,
                    policy=policy, config=cfg, seed=0)
                rec["events_seconds"] = time.perf_counter() - t0
                check(len(ev.events) == 3 and len(event_summary(ev)) == 3,
                      f"{policy}: {len(ev.events)} migrations, not 3")
                summ = event_summary(ev)
                rec.update({
                    "empty_and_split_equal_simulate": True,
                    "backend": base.backend,
                    "conservation_rel_err": conserved(ev.result, policy),
                    "migrations": migrations(ev),
                    "reroute": reroute, "segments": segs,
                    "final_switches": ev.tops[0].n_switches,
                    "throughput_retention_mean": [
                        float(np.nanmean(r["throughput_retention"]))
                        for r in summ],
                    "blackholed_total": float(
                        ev.result.blackholed_total.sum()),
                    "steady_throughput_mean": float(
                        steady_state_throughput(ev.result).mean()),
                    "steady_throughput_mean_no_events": float(
                        steady_state_throughput(base).mean())})
            ev, reroute, segs = traced_events_run(
                run, tops, comms, mtbf, wl, systems=systems, policy="ecmp",
                config=cfg, seed=0)
            out["mtbf"] = {
                "mtbf_steps": 40.0, "mttr_steps": 20.0,
                "start_step": steps // 6, "seed": 17, "policy": "ecmp",
                "events": [[e.step, e.kind] for e in mtbf],
                "conservation_rel_err": conserved(ev.result, "mtbf"),
                "migrations": migrations(ev), "reroute": reroute,
                "segment_backends": sorted({s["backend"] for s in segs}),
                "blackholed_total": float(ev.result.blackholed_total.sum())}

        _, out["seconds"] = run("events", path)
    finally:
        set_check_enabled(prev_checks)
    # the schedule at a reduced size: the card (dense) against the CPU
    # (gather), both from the same CPU-drawn stream of every segment
    b, sn, sp, snet, ssteps = small
    stops = [jellyfish(sn, sp, snet, seed=s) for s in range(b)]
    scomms = [random_permutation_traffic(t, seed=s)
              for s, t in enumerate(stops)]
    swl = steady_poisson(ssteps, rate=8.0, size=12.0)
    scfg = SimConfig(max_flows=512, max_arrivals=8, wf_iters=wf_iters)

    def arrivals(ts, logits, eos):
        return draw_arrivals(7, ts, swl.rate[ts], logits, eos,
                             swl.p_elephant, scfg.max_arrivals, device="cpu")

    runs = {}
    for where, dev, be in (("card", run.dev, "dense"), ("cpu", "cpu",
                                                         "gather")):
        clear_routing_cache()
        runs[where] = simulate_events(
            stops, scomms, event_schedule(ssteps, grow), swl, policy="ecmp",
            config=scfg, seed=7, backend=be, device=dev, arrivals=arrivals)
    card, cpu = runs["card"], runs["cpu"]
    check(migrations(card) == migrations(cpu),
          "reduced size: the card's migrations differ from the CPU's")
    worst = 0.0
    for f in SIM_FIELDS:
        x = np.asarray(getattr(card.result, f), np.float64)
        y = np.asarray(getattr(cpu.result, f), np.float64)
        gap = float(np.abs(x - y).max() / max(np.abs(y).max(), 1.0))
        check(gap <= SIM_ECMP_RTOL, f"reduced size: {f} on the card differs "
              f"from the CPU's by {gap} of its largest magnitude")
        worst = max(worst, gap)
    out["reduced"] = {"seeds": b, "n": sn, "ports": sp, "net_degree": snet,
                      "steps": ssteps, "policy": "ecmp",
                      "card_backend": card.result.backend,
                      "cpu_backend": cpu.result.backend,
                      "migrations": migrations(card),
                      "max_rel_gap": worst}
    out["launches"] = run.launches["events"]
    return out


#: Fingerprints of the ``families`` phase's topologies as the CPU builds
#: them (``edge_fingerprint``, seed 0; equal to the reference's by
#: ``tests/test_torch_families.py``).
FAMILY_FINGERPRINTS = {
    "swdc-ring": "13b95fb7241318af538037fe6e547ee609de95da",
    "swdc-torus2d": "4e3adad81e755989e24ca418088612980c4d5077",
    "swdc-hex3d": "67084dd4c15de03437a73cdffe2d60d1af4facae",
    "jellyfish": "055e7fd52df479d87fe78aa2a12b4df030a5625b",
    "fig12-jellyfish": "a1278994e333a29fcee586cc336bdf820a543db1",
    "fig12-local0": "fba6af03372716f30f517cdf00e404eb6698785a",
    "fig12-local5": "3d45f1e58bceb2eea3d964daf29f8134a172d0de",
    "dd-petersen": "cda673eba4a9a3a72dc1eda641084750ac9b4927",
    "dd-chvatal": "e0b96139a23a0ef1dc1c7c7031eb44119364e7d5",
    "dd-icosahedral": "f7b5bf0a062736d6c47805303f4f8340a0c43288",
    "dd-hoffman-singleton": "8e0f8716585e4bcccbefb12537d2542ba64df578",
    "dd-heawood": "44b6f1a86786116aa2e25f9255ff668fd7cbd486",
    "dd-mcgee": "608930e8353dbd3a8dff864ebd1aa34433520041",
    "dd-petersen-jellyfish": "9d9ab71931f5018f8e1b200451fdcd93f7e91ec5",
    "dd-chvatal-jellyfish": "1e249bd4c58f69335289a0e553b930efc724b7a1",
    "dd-icosahedral-jellyfish": "d680d1d094af23d00a926efcb6c8eea8733e7665",
    "dd-hoffman-singleton-jellyfish":
        "5f159ab8def7cc395763e6849972c07566defada",
    "dd-heawood-jellyfish": "41e9bf24ccebc41c65c9f9f2deb6d6c46dc1e745",
    "dd-mcgee-jellyfish": "b8c71fd6b9d1535cb80b615382d4c88955048bf8",
}
#: Fig 2's cases (``benchmarks/fig2_degree_diameter.py``): catalog graph,
#: servers per switch.
DD_CASES = (("petersen", 4), ("chvatal", 5), ("icosahedral", 6),
            ("hoffman-singleton", 9), ("heawood", 4), ("mcgee", 4))
#: MW alpha, dense against gather over 400 iterations: the CPU tests'
#: bound (tests/test_torch_flow.py).
MW_DENSE_GATHER_RTOL = 5e-3


def families_phase(run: PathRun, side: int = 22, sps: int = 2,
                   iters: int = 400, pods: int = 12, per_pod: int = 12,
                   r: int = 8, dd_cases=DD_CASES) -> dict:
    """The paper's other topology families at their figures' full sizes:
    Fig 3 (SWDC ring, 2D torus and 3D hex torus against Jellyfish on
    ``side``^2 switches of 8 ports, ``sps`` servers each), Fig 12
    (locality-restricted Jellyfish, ``pods`` x ``per_pod`` switches, ``r``
    network ports of 10) with its cable plan, and Fig 2 (degree-diameter
    graphs against Jellyfish on the same equipment).  Each topology equals
    the CPU build by fingerprint; each alpha is ``capacity.alpha_of`` with
    MW on ``dense`` (the single-incidence congestion kernel); the Fig 3
    alphas also on ``gather``, within ``MW_DENSE_GATHER_RTOL``."""
    import numpy as np

    from repro_torch import capacity
    from repro_torch.core import (
        DD_CATALOG,
        degree_diameter_graph,
        edge_fingerprint,
        jellyfish,
        jellyfish_heterogeneous,
        localized_jellyfish,
        plan_cables,
        swdc_hex3d,
        swdc_ring,
        swdc_torus2d,
    )
    from repro_torch.core.routing import clear_routing_cache

    n, ports = side * side, 6 + sps
    fig3 = {
        "swdc-ring": lambda: swdc_ring(n, ports, seed=0),
        "swdc-torus2d": lambda: swdc_torus2d(side, ports, seed=0),
        "swdc-hex3d": lambda: swdc_hex3d(6, max(n // 36, 1), ports, seed=0),
        "jellyfish": lambda: jellyfish_heterogeneous(
            np.full(n, ports), capacity.spread_servers(n * sps, n), seed=0),
    }
    fig12 = {"fig12-jellyfish": lambda: jellyfish(pods * per_pod, r + 2, r,
                                                  seed=0)}
    for local in (0, 5):
        fig12[f"fig12-local{local}"] = (
            lambda local=local: localized_jellyfish(pods, per_pod, r + 2, r,
                                                    local, seed=0))
    fig2 = {}
    for name, dd_sps in dd_cases:
        _, nn, deg, _ = DD_CATALOG[name]
        fig2[f"dd-{name}"] = (lambda name=name, p=deg + dd_sps:
                              degree_diameter_graph(name, p))
        fig2[f"dd-{name}-jellyfish"] = (
            lambda nn=nn, p=deg + dd_sps, s=dd_sps: jellyfish_heterogeneous(
                np.full(nn, p), capacity.spread_servers(nn * s, nn), seed=0))

    def alpha(top, backend):
        return capacity.alpha_of(top, seed=0, k=8, slack=3, method="mw",
                                 iters=iters, mw_backend=backend,
                                 device=run.dev)

    rows = {}

    def path():
        for name, build in {**fig3, **fig12, **fig2}.items():
            run.sync()
            t0 = time.perf_counter()
            top = build()
            a = alpha(top, "dense")
            run.sync()
            rows[name] = {"switches": top.n_switches,
                          "servers": int(top.n_servers), "alpha": a,
                          "seconds": time.perf_counter() - t0,
                          "fingerprint": edge_fingerprint(top)}
            if name in fig3:
                rows[name]["gather_alpha"] = alpha(top, "gather")
            if name in fig12:
                rows[name]["global_cable_fraction"] = (
                    1.0 - plan_cables(top).local_fraction)

    clear_routing_cache()
    _, secs = run("families", path)
    for name, row in rows.items():
        check(row["fingerprint"] == FAMILY_FINGERPRINTS[name],
              f"{name}: fingerprint differs from the CPU build's")
        if "gather_alpha" in row:
            rel = abs(row["alpha"] - row["gather_alpha"]) / max(
                abs(row["gather_alpha"]), 1e-12)
            check(rel <= MW_DENSE_GATHER_RTOL, f"{name}: MW alpha dense "
                  f"{row['alpha']} vs gather {row['gather_alpha']}")
            row["dense_vs_gather_rel"] = rel
    best_swdc = max(rows[k]["alpha"] for k in fig3 if k != "jellyfish")
    base12 = rows["fig12-jellyfish"]["alpha"]
    return {"phase": "families", "seconds": secs, "iters": iters,
            "topologies": rows,
            "fig3_jellyfish_vs_best_swdc":
                rows["jellyfish"]["alpha"] / best_swdc,
            "fig12_relative_throughput": {
                k: rows[k]["alpha"] / base12 for k in fig12},
            "fig2_jellyfish_fraction": {
                name: rows[f"dd-{name}-jellyfish"]["alpha"]
                / rows[f"dd-{name}"]["alpha"] for name, _ in dd_cases},
            "launches": run.launches["families"]}


#: ``benchmarks/fabric_scale.py``'s configuration: Jellyfish fabrics of
#: degree 8 at these pod counts (each also after 10 % of its links fail),
#: fat-trees up to 256 pods, 20 48-port switches joining a 100-switch
#: 24-port Jellyfish; the elastic delta chain and the all-to-all at these
#: pod counts.
FABRIC_PODS = (16, 64, 256, 1024)
FABRIC_FT_MAX = 256
FABRIC_HETERO = (100, 24, 16, 20)
FABRIC_CHAIN_PODS = 1024
FABRIC_A2A_PODS = (256, 1024)
#: Seconds the ``fabric`` phase must stay within.
FABRIC_BUDGET_S = 60.0


def same_ring(a, b, what: str) -> None:
    """Two ring embeddings are equal: order, hop paths, stretch and
    congestion."""
    import numpy as np

    check(np.array_equal(a.order, b.order), f"{what}: ring order differs")
    check(a.hop_paths == b.hop_paths, f"{what}: ring hop paths differ")
    check((a.stretch, a.congestion, a.efficiency)
          == (b.stretch, b.congestion, b.efficiency),
          f"{what}: stretch/congestion differ")


def fabric_phase(run: PathRun, pods=FABRIC_PODS, ft_max: int = FABRIC_FT_MAX,
                 hetero=FABRIC_HETERO, chain_pods: int = FABRIC_CHAIN_PODS,
                 a2a_pods=FABRIC_A2A_PODS, grow: int = 64) -> dict:
    """``benchmarks/fabric_scale.py``'s configuration through the port's
    fabric layer, timed with ``obs.bench.Timer(device=...)``.

    Rings (Jellyfish of degree 8, then 10 % of its links failed; fat-trees
    up to ``ft_max`` pods), the elastic delta chain (``path_system``, then
    ``fail(0.1)``, ``expand(64)`` and ``remove(7)``, each followed by
    ``path_system``) and ``a2a_efficiency``: each ring and all-to-all score
    on ``run.dev`` equals the same call on the CPU (host BFS, numpy
    admission; each run from a cleared routing cache), and each delta path
    system equals ``build_path_system(..., cache=False)`` on ``run.dev``
    field by field.  The largest all-to-all is traced (spans
    ``fabric/a2a/*``) on both devices: its seconds split into the hop
    matrix, the enumeration and the Python usage loop
    (``tools/fabric_a2a_profile.py`` gives the kernels' device time inside
    the enumeration)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import (
        add_switch,
        build_path_system,
        jellyfish,
        path_stats,
        random_permutation_traffic,
    )
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.core.traffic import Commodities
    from repro_torch.fabric import make_fabric

    cpu = torch.device("cpu")
    Timer = obs.Timer

    def on_both(fn):
        """``fn(device)`` on ``run.dev`` (timed on its clock) and on the CPU,
        each from a cleared routing cache: (card, cpu, secs, cpu_secs)."""
        clear_routing_cache()
        with Timer(device=run.dev) as t:
            got = fn(run.dev)
        clear_routing_cache()
        with Timer() as tc:
            ref = fn(cpu)
        return got, ref, t.dt, tc.dt

    out = {"phase": "fabric", "rings": [], "chain": [], "a2a": []}

    def rings():
        for n in pods:
            def jf(dev, n=n):
                fb = make_fabric("jellyfish", n_pods=n, degree=8, seed=0,
                                 device=dev)
                return fb.ring(), fb.fail(0.1, seed=1).ring()

            (ej, ef), (cj, cf), secs, cpu_secs = on_both(jf)
            same_ring(ej, cj, f"jellyfish {n} pods")
            same_ring(ef, cf, f"jellyfish {n} pods after 10 % failure")
            row = {"pods": n, "jf_stretch": ej.stretch,
                   "jf_congestion": ej.congestion,
                   "jf_efficiency": ej.efficiency,
                   "jf_stretch_after_10pct_fail": ef.stretch,
                   "jf_congestion_after_fail": ef.congestion,
                   "jf_efficiency_after_fail": ef.efficiency,
                   "seconds": secs, "cpu_seconds": cpu_secs}
            if n <= ft_max:
                def ft(dev, n=n):
                    fb = make_fabric("fattree", n_pods=n, device=dev)
                    return fb, fb.ring()

                (fg, eg), (_, ec), secs, cpu_secs = on_both(ft)
                same_ring(eg, ec, f"fat-tree {n} pods")
                row.update({"ft_name": fg.name,
                            "ft_switches": fg.topology.n_switches,
                            "ft_stretch": eg.stretch,
                            "ft_congestion": eg.congestion,
                            "ft_efficiency": eg.efficiency,
                            "ft_seconds": secs, "ft_cpu_seconds": cpu_secs})
            out["rings"].append(row)

    def expansion():
        # heterogeneous expansion (§4.2): 48-port switches join a 24-port
        # Jellyfish; path lengths stay short and the graph valid
        n0, ports0, r0, joiners = hetero
        with Timer() as t:
            top = jellyfish(n0, ports0, r0, seed=0)
            base = path_stats(top).mean
            for i in range(joiners):
                top = add_switch(top, 48, 32, seed=100 + i)
            st = path_stats(top)
            top.validate()
        out["hetero"] = {"base_mean_path": base, "after_mean_path": st.mean,
                         "n_switches": top.n_switches,
                         "degree_mix": sorted(set(top.net_degree.tolist())),
                         "seconds": t.dt}

    def chain():
        clear_routing_cache()
        fb = make_fabric("jellyfish", n_pods=chain_pods, degree=8, seed=0,
                         device=run.dev)
        comm = random_permutation_traffic(fb.topology, seed=0)
        with Timer(device=run.dev) as t:
            ps = fb.path_system(comm, k=8)
        out["chain"].append({"step": "build", "switches": fb.topology.n_switches,
                             "paths": ps.n_paths, "seconds": t.dt})
        for what, args, seed in (("fail", (0.1,), 1), ("expand", (grow,), 2),
                                 ("remove", (7,), 3)):
            fb = getattr(fb, what)(*args, seed=seed)
            if what == "remove":
                nm = np.asarray(fb.topology.meta["node_remap"])
                keep = (nm[comm.src] >= 0) & (nm[comm.dst] >= 0)
                comm = Commodities(src=nm[comm.src[keep]],
                                   dst=nm[comm.dst[keep]],
                                   demand=comm.demand[keep],
                                   n_flows=int(keep.sum()))
            with Timer(device=run.dev) as t:
                ps = fb.path_system(comm, k=8)
            with Timer(device=run.dev) as tr:
                full = build_path_system(fb.topology, comm, k=8, cache=False,
                                         device=run.dev)
            same_system(ps, full, f"fabric {what} delta")
            check(ps.row_map is not None,
                  f"fabric {what}: path_system fell back to a rebuild")
            out["chain"].append({
                "step": what, "switches": fb.topology.n_switches,
                "links": fb.topology.n_edges, "paths": ps.n_paths,
                "delta": ps.row_map is not None,
                "reused_rows": (int((ps.row_map >= 0).sum())
                                if ps.row_map is not None else 0),
                "delta_seconds": t.dt, "rebuild_seconds": tr.dt})

    def a2a():
        for n in a2a_pods:
            largest = n == max(a2a_pods)

            def eff(dev, n=n, largest=largest):
                fb = make_fabric("jellyfish", n_pods=n, degree=8, seed=0,
                                 device=dev)
                if not largest:
                    return fb.a2a_efficiency(), None
                # the largest: traced, for the split of its seconds
                prev = obs.set_trace(True)
                obs.reset_trace()
                try:
                    e = fb.a2a_efficiency()
                    spans = {s.name.rsplit("/", 1)[-1] + "_s": s.wall_s
                             for s in obs.get_spans()
                             if s.name.startswith("fabric/a2a/")}
                finally:
                    obs.set_trace(prev)
                    obs.reset_trace()
                return e, spans

            (eg, split), (ec, cpu_split), secs, cpu_secs = on_both(eff)
            check(eg == ec, f"all-to-all at {n} pods: {eg} on the card, "
                  f"{ec} on the CPU")
            row = {"pods": n, "a2a_efficiency": eg, "seconds": secs,
                   "cpu_seconds": cpu_secs}
            if split is not None:
                row.update({"split": split, "cpu_split": cpu_split})
            out["a2a"].append(row)

    def path():
        rings()
        expansion()
        chain()
        a2a()

    _, secs = run("fabric", path)
    out.update({"seconds": secs, "launches": run.launches["fabric"]})
    return out


# --------------------------------------------------------------------------- #
# the model stack's serving path (repro_torch.models, launch.serve)
# --------------------------------------------------------------------------- #

#: Serve phase: every registered arch at ``reduced()`` in float32, card
#: against CPU from one set of weights; a 24-token prompt wraps the 16-slot
#: windows of mixtral and recurrentgemma, and 10 decode steps pass 32.
SERVE_REDUCED_PROMPT, SERVE_REDUCED_STEPS = 24, 10
#: Card against CPU, both float32 with TF32 off: the CPU tests' bounds
#: (tests/test_torch_serve.py), which the sums' different orders meet.
SERVE_LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
SERVE_CACHE_TOL = dict(rtol=1e-4, atol=5e-5)
#: Full width, as ``serve`` runs it: batch 4, prompt 32, 16 new tokens.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 32, 16
SERVE_DEFAULT = "rwkv6-1.6b"
SERVE_FAMILIES = ("minitron-8b", "qwen2-moe-a2.7b", "recurrentgemma-2b")
#: The float32 twins: the arch's weights drawn in float32 on the card and
#: run first (prefill and SERVE_TWIN_STEPS greedy decode steps), then cast
#: to bf16 in place for serving, so one card holds qwen-moe's 57 GB of
#: float32.  Family -> the dtypes of the copies that also run on the CPU.
SERVE_TWINS = {"rwkv6": ("float32", "float64"), "moe": ()}
SERVE_TWIN_STEPS = 4
#: Bounds on the largest difference over the largest magnitude of the
#: reference side (readings: an H100, PERF.md):
#: - f32 card against f32 CPU: 2e-3; against float64 on the CPU: 1e-3 (the
#:   CPU's own f32 reads 3.4e-4 from float64 at rwkv's full width, the
#:   card's 2.8e-5).
#: - bf16 against its f32 twin, each layer alone (its input the twin's f32
#:   stream, rounded to bf16) in the prefill and the first decode step, and
#:   the final norm and head on the twin's last stream: 0.05 (rwkv read
#:   0.030 at most).  The MoE's prefill layers are read, not bounded: its
#:   bf16 router may move a token's fourth expert or its drop at capacity,
#:   a step change (0.049 in the first layer at full width, 0.18 at
#:   reduced()); its drop-free decode layers are bounded.
#: - bf16 against f32 end to end: qwen-moe 0.1 (read 0.024).  rwkv 0.75,
#:   under the 1.0 that all-zero logits read and above its read 0.54:
#:   random-init RWKV-6 amplifies the rounding of its first positions
#:   (whose wkv output has rank one or two) over 24 layers until the logits
#:   move by half their scale, and the reference does the same
#:   (tests/test_torch_bf16.py), so its layers alone are the gate that
#:   holds its bf16 math.
#: - bf16 decode against a fresh bf16 prefill: 0.1.
#: - A stream that no longer depends on its tokens gives one greedy token
#:   at every position of a row: every prompt row must give at least two.
SERVE_CPU_TWIN_REL = {"float32": 2e-3, "float64": 1e-3}
SERVE_BF16_LAYER_REL = 0.05
SERVE_BF16_REL = {"rwkv6": 0.75, "moe": 0.1}
SERVE_DECODE_BF16_REL = 0.1
SERVE_BUDGET_S = 90.0


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32 on the host."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).abs().max() / w.abs().max())


def _copy_model(model, dtype, device):
    """The same weights in a new ``LM`` (cast to ``dtype``) on ``device``."""
    from repro_torch.models import LM

    out = LM(model.cfg, seed=None, dtype=dtype, device=device)
    out.load_state_dict(model.state_dict())
    return out


def _close_or_fail(got, want, tol: dict, what: str) -> float:
    import torch

    g, w = got.detach().cpu(), want.detach().cpu()
    if g.dtype in (torch.int32, torch.int64):
        check(torch.equal(g, w), f"{what} differs")
        return 0.0
    check(torch.allclose(g, w, **tol),
          f"{what}: largest difference {float((g - w).abs().max()):.3g} "
          f"outside rtol {tol['rtol']}, atol {tol['atol']}")
    return float((g - w).abs().max())


def serve_reduced(dev, arch: str) -> dict:
    """One reduced arch in float32: the same weights on the card and on the
    CPU; prefill logits, every cache tensor, the greedy decode steps'
    logits and the tokens must agree."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get(arch).reduced()
    prompt, steps = SERVE_REDUCED_PROMPT, SERVE_REDUCED_STEPS
    cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = _copy_model(cpu, torch.float32, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt),
                         generator=torch.Generator().manual_seed(1))
    max_len = prompt + steps
    lc, cc = prefill(cpu, {"tokens": toks}, max_len=max_len)
    lg, cg = prefill(card, {"tokens": toks.to(dev)}, max_len=max_len)
    logit_err = _close_or_fail(lg, lc, SERVE_LOGIT_TOL, f"{arch} prefill")
    cache_err = 0.0
    for layer, (a, b) in enumerate(zip(cg, cc)):
        for k in b:
            cache_err = max(cache_err, _close_or_fail(
                a[k], b[k], SERVE_CACHE_TOL, f"{arch} layer {layer} {k}"))
    tokens_equal = True
    for i in range(steps):
        tc = torch.argmax(lc[:, :cfg.vocab_size], -1)
        tg = torch.argmax(lg[:, :cfg.vocab_size], -1)
        tokens_equal &= bool(torch.equal(tg.cpu(), tc))
        check(tokens_equal, f"{arch}: greedy tokens differ at step {i}")
        lc, cc = decode_step(cpu, cc, tc, prompt + i)
        lg, cg = decode_step(card, cg, tg, prompt + i)
        logit_err = max(logit_err, _close_or_fail(
            lg, lc, SERVE_LOGIT_TOL, f"{arch} decode step {i}"))
    slots = [int(c["k"].shape[1]) for c in cg if "k" in c]
    return {"logit_max_abs_err": logit_err, "cache_max_abs_err": cache_err,
            "tokens_equal": tokens_equal, "kv_slots": min(slots or [0])}


def run_steps(model, prompt, steps: int, tokens=None) -> dict:
    """Prefill ``prompt`` (B, S) and decode ``steps`` steps, greedy unless
    ``tokens`` (B, steps) are given.  Returns each step's logits, the
    tokens fed, and the residual stream after every layer of the prefill
    and of the first decode step (all float32, on the host)."""
    import torch

    from repro_torch.models import decode_step, prefill

    streams = []
    hooks = [blk.register_forward_hook(
        lambda _m, _i, out: streams.append(out[0].detach().float().cpu()))
        for blk in model.blocks]
    dev, s, vocab = model.device, prompt.shape[1], model.cfg.vocab_size
    try:
        lg, cache = prefill(model, {"tokens": prompt.to(dev)},
                            max_len=s + steps)
        logits, fed = [lg.float().cpu()], []
        for i in range(steps):
            tok = (tokens[:, i] if tokens is not None
                   else torch.argmax(lg[:, :vocab], -1).cpu())
            fed.append(tok)
            lg, cache = decode_step(model, cache, tok.to(dev), s + i)
            logits.append(lg.float().cpu())
    finally:
        for h in hooks:
            h.remove()
    n = len(model.blocks)
    return {"logits": logits, "tokens": torch.stack(fed, dim=1),
            "prefill": streams[:n], "decode": streams[n:2 * n]}


def _block(model, i: int, x, positions, cache):
    if model.kinds[i] == "attn":
        y, cache, _ = model.blocks[i](x, positions, model.cfg, cache)
        return y, cache
    return model.blocks[i](x, cache, model.cfg)


def layer_gaps(m16, twin: dict, prompt) -> dict:
    """Each bf16 layer alone against its f32 twin: its input the twin's
    stream before it (rounded to bf16), prefill and then the first decode
    step with the cache that prefill left; and the bf16 final norm and head
    on the twin's last decode stream.  Errors as ``rel_err``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import init_cache
    from repro_torch.models.layers import rmsnorm

    cfg, dev, dt = m16.cfg, m16.device, m16.dtype
    b, s = prompt.shape
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    pos1 = torch.full((1,), s, dtype=torch.int32, device=dev)
    tok = twin["tokens"][:, :1].to(dev)
    ins = {"prefill": [F.embedding(prompt.to(dev), m16.embed)]
           + twin["prefill"][:-1],
           "decode": [F.embedding(tok, m16.embed)] + twin["decode"][:-1]}
    caches = init_cache(cfg, b, s + 1, dt, dev)
    gaps = {"prefill": [], "decode": []}
    for i in range(len(m16.blocks)):
        y, cache = _block(m16, i, ins["prefill"][i].to(dev, dt), pos,
                          caches[i])
        gaps["prefill"].append(rel_err(y, twin["prefill"][i]))
        y, _ = _block(m16, i, ins["decode"][i].to(dev, dt), pos1, cache)
        gaps["decode"].append(rel_err(y, twin["decode"][i]))
    y = rmsnorm(twin["decode"][-1].to(dev, dt), m16.final_norm, cfg.norm_eps)
    gaps["head"] = rel_err(m16.logits(y)[:, 0], twin["logits"][1])
    return gaps


def prefill_argmax(model, prompt) -> tuple:
    """One prefill of ``prompt`` (B, S): the greedy token at every position
    if the stream went to the final norm and head after each layer (a
    list, one (B, S) tensor a layer; the last is the model's own), and each
    layer's share of the stream that varies over a row's positions,
    sum |x - mean_s x|^2 / sum |x|^2."""
    import torch

    from repro_torch.models import prefill
    from repro_torch.models.layers import rmsnorm

    seen = []
    hooks = [blk.register_forward_hook(
        lambda _m, _i, out: seen.append(out[0])) for blk in model.blocks]
    try:
        prefill(model, {"tokens": prompt}, max_len=prompt.shape[1])
    finally:
        for h in hooks:
            h.remove()
    tokens, shares = [], []
    for x in seen:
        y = rmsnorm(x, model.final_norm, model.cfg.norm_eps)
        tokens.append(torch.argmax(
            model.logits(y)[..., :model.cfg.vocab_size], -1))
        x = x.float()
        shares.append(float(((x - x.mean(1, keepdim=True)) ** 2).sum()
                            / (x ** 2).sum()))
    return tokens, shares


def _model_sizes(model) -> dict:
    """Parameters and bytes counted from the module, and the decode step's
    HBM bound: the bytes it must read over the card's rate.  That is every
    parameter but an untied input embedding, of which a step gathers only
    one row a sequence (a tied table is read whole as the LM head)."""
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    read = nbytes
    if hasattr(model, "lm_head"):
        read -= model.embed.numel() * model.embed.element_size()
    return {"params": n, "param_bytes": nbytes, "decode_read_bytes": read,
            "analytic_params": model.cfg.param_count(),
            "decode_hbm_bound_ms": read / HBM_BYTES_PER_S * 1e3}


def _timed_generate(model, prompts, max_new: int):
    """``serve.generate`` once to warm the card's libraries, then timed."""
    from repro_torch.launch.serve import generate

    generate(model, prompts, 2)
    return generate(model, prompts, max_new)


def traced(fn) -> dict:
    """``fn()`` once untraced and once under ``torch.profiler`` (device
    activity), each synchronized: the device-busy share of the traced
    window, the kernels launched and the five operations with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    ops = [(ev.key, ev.device_time_total / 1e3, ev.count)
           for ev in prof.key_averages() if not ev.key.startswith("cuda")]
    busy_ms = sum(t for _, t, _ in ops)
    if busy_ms == 0.0:
        return {"timer": "not measured: the profiler saw no device activity",
                "window_ms": window_ms, "untraced_ms": untraced_ms}
    top = sorted(ops, key=lambda o: -o[1])[:5]
    return {"timer": "profiler", "window_ms": window_ms,
            "untraced_ms": untraced_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / window_ms,
            "device_busy_share_of_untraced": busy_ms / untraced_ms,
            "kernel_launches": sum(n for _, _, n in ops),
            "top_ops": [{"name": k[:120], "device_ms": t, "count": n}
                        for k, t, n in top]}


def decode_trace(model, cache, token, pos: int) -> dict:
    """One decode step traced (``traced``).  Both runs write ``pos`` into
    ``cache`` in place (the same slot, the same values)."""
    from repro_torch.models import decode_step

    return traced(lambda: decode_step(model, cache, token, pos))


def serve_full(dev, cfg) -> dict:
    """One model at full width in bf16, as ``serve`` runs it: ``generate``
    timed (prefill ms, decode ms a token), finite logits, tokens in range,
    greedy tokens that vary over the prompt's positions, decode against a
    fresh prefill of the longer prompt for 3 steps (drop-free MoE
    capacity), and on the card one traced decode step.  A family in
    ``SERVE_TWINS`` first runs its weights in float32 (on the card, and on
    the CPU in the listed dtypes), and its bf16 run of the same tokens is
    then held against the card's float32, layer by layer and at the
    logits."""
    import dataclasses
    import gc

    import torch

    from repro_torch.models import decode_step, init_params, prefill

    cuda = dev.type == "cuda"
    b, s = SERVE_BATCH, SERVE_PROMPT
    prompts = torch.randint(0, cfg.vocab_size, (b, s + 3),
                            generator=torch.Generator().manual_seed(2))
    out, errs = {}, {}
    cpu_twins = SERVE_TWINS.get(cfg.family)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_init = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16
                        if cpu_twins is None else torch.float32)
    if cuda:
        torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t_init
    if cpu_twins is not None:
        twin = run_steps(model, prompts[:, :s], SERVE_TWIN_STEPS)
        cpu_logits = {}
        for name in cpu_twins:
            cpu = _copy_model(model, getattr(torch, name), "cpu")
            cpu_logits[name] = run_steps(cpu, prompts[:, :s],
                                         SERVE_TWIN_STEPS,
                                         twin["tokens"])["logits"]
            del cpu
            err = [rel_err(a, c) for a, c in zip(twin["logits"],
                                                 cpu_logits[name])]
            check(max(err) <= SERVE_CPU_TWIN_REL[name],
                  f"{cfg.name}: f32 card against {name} on the CPU "
                  f"{max(err):.3g} > {SERVE_CPU_TWIN_REL[name]} of the "
                  "largest |logit|")
            errs[f"f32_card_vs_cpu_{name}_rel"] = err
        if {"float32", "float64"} <= set(cpu_logits):
            errs["f32_cpu_vs_float64_rel"] = [
                rel_err(a, c) for a, c in zip(cpu_logits["float32"],
                                              cpu_logits["float64"])]
        del cpu_logits
        if cuda:
            out["twin_peak_allocated_bytes"] = torch.cuda.max_memory_allocated(
                dev)
        model.to(torch.bfloat16)  # in place, one tensor at a time
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    out.update(_model_sizes(model))

    g = _timed_generate(model, prompts[:, :s], SERVE_NEW)
    toks = g.tokens
    check(toks.shape == (b, SERVE_NEW), f"{cfg.name}: tokens {toks.shape}")
    check(bool(torch.all((toks >= 0) & (toks < cfg.vocab_size))),
          f"{cfg.name}: a generated token lies outside [0, vocab_size)")
    out.update({"prefill_ms": g.prefill_ms,
                "decode_ms_per_token": g.decode_ms_per_token,
                "tokens": toks.tolist()})
    out["decode_over_bound"] = (out["decode_ms_per_token"]
                                / out["decode_hbm_bound_ms"])
    p = prompts.to(dev)
    by_layer, shares = prefill_argmax(model, p[:, :s])
    per_row = [len(set(row)) for row in by_layer[-1].tolist()]
    out.update({"prefill_argmax_distinct_by_layer": [
                    int(torch.unique(t).numel()) for t in by_layer],
                "prefill_argmax_distinct_per_row": per_row,
                "position_varying_share_by_layer": shares})
    check(min(per_row) >= 2,
          f"{cfg.name}: one greedy token at every position of a prompt row "
          f"({per_row} distinct a row)")

    # decode against a fresh prefill of the longer prompt
    run_cfg = model.cfg
    if cfg.family == "moe":
        model.cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    logits, cache = prefill(model, {"tokens": p[:, :s]}, max_len=s + 3)
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: non-finite prefill logits")
    dec = []
    for i in range(3):
        want, _ = prefill(model, {"tokens": p[:, :s + i + 1]}, max_len=s + 3)
        got, cache = decode_step(model, cache, p[:, s + i], s + i)
        check(bool(torch.isfinite(got).all()),
              f"{cfg.name}: non-finite decode logits")
        dec.append(rel_err(got, want))
    check(max(dec) <= SERVE_DECODE_BF16_REL,
          f"{cfg.name}: bf16 decode against prefill {max(dec):.3g} > "
          f"{SERVE_DECODE_BF16_REL} of the largest |logit|")
    model.cfg = run_cfg
    out["decode_vs_prefill_rel"] = dec

    if cpu_twins is not None:
        run16 = run_steps(model, prompts[:, :s], SERVE_TWIN_STEPS,
                          twin["tokens"])
        errs["bf16_vs_f32_rel"] = [rel_err(a, c) for a, c in
                                   zip(run16["logits"], twin["logits"])]
        errs["bf16_f32_greedy_agreement"] = [
            float((torch.argmax(a[:, :cfg.vocab_size], -1)
                   == torch.argmax(c[:, :cfg.vocab_size], -1)).float().mean())
            for a, c in zip(run16["logits"], twin["logits"])]
        gaps = layer_gaps(model, twin, prompts[:, :s])
        gated = gaps["decode"] + [gaps["head"]]
        if cfg.family != "moe":
            gated += gaps["prefill"]
        check(max(gated) <= SERVE_BF16_LAYER_REL,
              f"{cfg.name}: a bf16 layer alone against its f32 twin "
              f"{max(gated):.3g} > {SERVE_BF16_LAYER_REL}")
        bound = SERVE_BF16_REL[cfg.family]
        bf16_max = max(errs["bf16_vs_f32_rel"])
        check(bf16_max <= bound,
              f"{cfg.name}: bf16 against f32 {bf16_max:.3g} > {bound} of "
              "the largest |logit|")
        out.update({**errs, "bf16_layer_alone_rel": gaps})
        del twin, run16
    if cuda:
        logits, cache = prefill(model, {"tokens": p[:, :s]}, max_len=s + 1)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
        out["decode_trace"] = decode_trace(model, cache, tok, s)
    del model, cache
    gc.collect()
    if cuda:
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
    return out


def serve_phase(dev, shrink=None) -> dict:
    """The serving path: every registered arch at ``reduced()`` card against
    CPU (float32), then ``rwkv6-1.6b`` (serve's default) and one model per
    other family at full width in bf16.  ``shrink`` maps a full config to a
    smaller one (a CPU rehearsal only); none of the port's five kernels runs
    here, and the launch counts say so."""
    from repro_torch import kernels
    from repro_torch.configs import get, names

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    reduced = {arch: serve_reduced(dev, arch) for arch in names()}
    shrink = shrink or (lambda c: c)
    full = {arch: serve_full(dev, shrink(get(arch)))
            for arch in (SERVE_DEFAULT, *SERVE_FAMILIES)}
    return {"phase": "serve", "reduced": reduced, "full": full,
            "kernel_launches": kernels.launch_counts(),
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------- #
# the model stack's training path
# --------------------------------------------------------------------------- #

#: Train phase, reduced: every registered arch in float32 (TF32 off), one
#: ``make_train_step`` step at lr 1e-3 from the same weights and batch on the
#: card and on the CPU, held to the CPU tests' bounds
#: (tests/test_torch_train.py): the loss rtol 1e-6; the global gradient norm
#: rtol ``train_rel``; ``mu`` within ``train_rel`` of each leaf's largest
#: magnitude, ``nu`` within twice that; the parameters atol 3e-4.
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-6
TRAIN_PARAM_ATOL = 3e-4
#: ``microbatches=2`` against 1 on the card, the reference's bounds
#: (tests/test_launch.py::test_train_step_microbatch_equivalence): the loss
#: rel 1e-4, the parameters rtol 2e-3, atol 2e-4.
TRAIN_MB_LOSS_REL = 1e-4
TRAIN_MB_TOL = dict(rtol=2e-3, atol=2e-4)
#: ``remat`` none / full / dots: every gradient leaf within 1e-6 of its
#: largest magnitude (the recomputed forward repeats the same operations;
#: on the CPU the gradients are equal bit for bit).
TRAIN_REMAT_REL = 1e-6
TRAIN_REMAT_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
                     "recurrentgemma-2b")
TRAIN_INT8_STEPS = 8
#: Full width through ``launch.train.main`` at its defaults (batch 8,
#: sequence 128, ``cfg.remat`` = full), 12 steps, no checkpoint in the
#: window; bf16, the f32 twin for step 1's forward and backward.
TRAIN_FULL = ("rwkv6-1.6b", "internvl2-1b")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 12, 8, 128
#: Timed full steps (the first warms the card's libraries); the best is
#: the step time.
TRAIN_TIMED_STEPS = 3
#: The H100 SXM's dense bf16 tensor-core peak (data sheet, 700 W), the
#: denominator of the model-FLOP utilization 6 N tokens / step time.
BF16_FLOP_PER_S = 989e12
#: bf16 against the f32 twin of the same weights at step 1, relative:
#: - the loss, end to end: 0.005;
#: - the global gradient norm, end to end: 0.01 for internvl2; read, not
#:   bounded, for rwkv: at random init its gradient grows with depth (149 at
#:   2 layers, 1,506 at 6, the same in both packages in f32 on the CPU), and
#:   bf16 moves it far in both packages (969 and 5,674 at 6 layers);
#: - each block's backward alone (``layer_backward_gaps``): its input- and
#:   weight-gradient gaps within 20x the rounding floor (an f32 run on the
#:   bf16-rounded operands) in every block, and within 0.05 for internvl2;
#:   the head's within 0.02.  RWKV-6's backward at random init is
#:   ill-conditioned, in the reference as in the port: on the card the
#:   rounding of the operands alone moves a block's gradients by up to 0.52,
#:   and bf16 arithmetic by 0.01-0.82, at most 10.6x the floor (PERF.md); on
#:   the CPU at full width, 3 layers, on the reference's own weights the
#:   reference's first block reads 0.45 (input gradient), the port's 0.15.
#:   So its gaps are held to the floor, with twice the largest ratio read.
TRAIN_BF16_LOSS_REL = 0.005
TRAIN_BF16_GNORM_REL = {"dense": 0.01}
TRAIN_BF16_LAYER_REL = {"dense": 0.05}
TRAIN_BF16_OVER_FLOOR = 20.0
TRAIN_BF16_HEAD_REL = 0.02
#: The phase aims at 90 s; the check allows for the host clock's spread.
TRAIN_BUDGET_S = 120.0


def train_rel(arch: str) -> float:
    return 2e-4 if arch.startswith("rwkv6") else 2e-5


def train_batch(cfg, seed: int, b: int = 4, s: int = 16) -> dict:
    """The arch's batch form, drawn on the CPU: tokens; the VLM prefix and
    tokens; audio embeddings and labels (three masked)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if cfg.frontend == "vit":
        return {"inputs_embeds": torch.randn((b, 4, cfg.d_model),
                                             generator=g) * 0.02,
                "tokens": torch.randint(0, cfg.vocab_size, (b, s - 4),
                                        generator=g)}
    if cfg.frontend == "encodec":
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
        labels[0, :3] = -1
        return {"inputs_embeds": torch.randn((b, s, cfg.d_model),
                                             generator=g) * 0.02,
                "labels": labels}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}


def _on(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def leaf_rel(got: dict, want: dict) -> float:
    """The largest over the leaves of max |got - want| / max |want|."""
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].detach().float().cpu(), w.detach().float().cpu()
        gap = float((g - w).abs().max()) if w.numel() else 0.0
        top = float(w.abs().max()) if w.numel() else 0.0
        worst = max(worst, gap / top if top else (0.0 if gap == 0 else
                                                  float("inf")))
    return worst


def train_reduced(dev, arch: str) -> dict:
    """One reduced arch in float32: one step from the same weights and
    batch on the card and on the CPU."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get(arch).reduced()
    cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = _copy_model(cpu, torch.float32, dev)
    batch = train_batch(cfg, seed=3)
    step = make_train_step(cfg, lr=TRAIN_LR, dtype=torch.float32)
    runs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        _, opt, m = step(model, adamw_init(model),
                         _on(batch, model.device))
        runs[name] = (model, opt, m)
    (mc, oc, metc), (mg, og, metg) = runs["cpu"], runs["card"]
    out = {"loss_rel": abs(float(metg["loss"]) / float(metc["loss"]) - 1),
           "grad_norm_rel": abs(float(metg["grad_norm"])
                                / float(metc["grad_norm"]) - 1),
           "mu_rel": leaf_rel(og.mu, oc.mu), "nu_rel": leaf_rel(og.nu, oc.nu),
           "param_max_abs_err": max(
               float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(mg.parameters(), mc.parameters())),
           "loss": float(metg["loss"])}
    rel = train_rel(arch)
    check(out["loss_rel"] <= TRAIN_LOSS_RTOL,
          f"{arch}: card loss {out['loss_rel']:.3g} from the CPU's")
    check(out["grad_norm_rel"] <= rel,
          f"{arch}: card grad norm {out['grad_norm_rel']:.3g} from the CPU's")
    check(out["mu_rel"] <= rel and out["nu_rel"] <= 2 * rel,
          f"{arch}: card mu / nu {out['mu_rel']:.3g} / {out['nu_rel']:.3g} "
          "from the CPU's")
    check(out["param_max_abs_err"] <= TRAIN_PARAM_ATOL,
          f"{arch}: card parameters {out['param_max_abs_err']:.3g} from the "
          "CPU's")
    return out


def train_microbatches(dev) -> dict:
    """``microbatches=2`` against 1 on the card (musicgen, as the
    reference's test)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get("musicgen-medium").reduced()
    g = torch.Generator().manual_seed(2)
    batch = _on({"inputs_embeds": torch.randn((4, 12, cfg.d_model),
                                              generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (4, 12),
                                         generator=g)}, dev)
    outs = []
    for mb in (1, 2):
        model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        step = make_train_step(cfg, microbatches=mb, lr=TRAIN_LR,
                               dtype=torch.float32)
        _, _, m = step(model, adamw_init(model), batch)
        outs.append((model, float(m["loss"])))
    loss_rel = abs(outs[1][1] / outs[0][1] - 1)
    check(loss_rel <= TRAIN_MB_LOSS_REL,
          f"microbatches=2 loss {loss_rel:.3g} from microbatches=1")
    worst = 0.0
    for a, b in zip(outs[1][0].parameters(), outs[0][0].parameters()):
        check(torch.allclose(a, b, **TRAIN_MB_TOL),
              "microbatches=2 parameters outside the reference's bounds")
        worst = max(worst, float((a - b).abs().max().detach()))
    return {"arch": cfg.name, "loss_rel": loss_rel, "param_max_abs_err": worst}


def train_int8(dev) -> dict:
    """``grad_compression=True``: 8 steps on one batch (internvl2, as the
    reference's test), the loss finite and falling."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, ef_init

    cfg = get("internvl2-1b").reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    opt, err = adamw_init(model), ef_init(model)
    step = make_train_step(cfg, lr=TRAIN_LR, grad_compression=True,
                           dtype=torch.float32)
    batch = _on(train_batch(cfg, seed=1, b=2, s=24), dev)
    losses = []
    for _ in range(TRAIN_INT8_STEPS):
        _, opt, m, err = step(model, opt, batch, err)
        losses.append(float(m["loss"]))
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"int8 error feedback: losses {losses}")
    return {"arch": cfg.name, "losses": losses}


def train_remat(dev, arch: str) -> dict:
    """The gradients of one batch with ``remat`` none, full and dots, from
    the same weights."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.models import init_params, loss_fn

    cfg = get(arch).reduced()
    base = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    batch = _on(train_batch(cfg, seed=8), dev)
    grads = {}
    for remat in ("none", "full", "dots"):
        base.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = loss_fn(base, batch)
        names = [n for n, _ in base.named_parameters()]
        gs = torch.autograd.grad(loss, list(base.parameters()),
                                 allow_unused=True, materialize_grads=True)
        grads[remat] = dict(zip(names, gs))
    base.cfg = cfg
    out = {}
    for remat in ("full", "dots"):
        out[f"{remat}_rel"] = leaf_rel(grads[remat], grads["none"])
        out[f"{remat}_bit_equal"] = all(
            torch.equal(grads[remat][n], grads["none"][n]) for n in names)
        check(out[f"{remat}_rel"] <= TRAIN_REMAT_REL,
              f"{arch}: remat={remat} gradients {out[f'{remat}_rel']:.3g} "
              "from remat=none")
    return out


def _lm_loop(dev, root, n_steps: int, chaos=None, nan_at=()):
    """``launch.train``'s loop over reduced internvl2 in float32 on ``dev``,
    checkpoints every 5 steps; the batch of each step in ``nan_at`` carries
    a NaN input embedding.  Returns (model, loop state, report)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _bind
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.fault import FaultConfig, ResilientLoop

    cfg = get("internvl2-1b").reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    step_fn = make_train_step(cfg, lr=TRAIN_LR, dtype=torch.float32)
    state = {"params": dict(model.named_parameters()),
             "opt": adamw_init(model)}

    def run_step(state, batch):
        _bind(model, state["params"])
        _, opt, m = step_fn(model, state["opt"], batch)
        return {"params": dict(model.named_parameters()), "opt": opt}, m

    def batch_at(step):
        b = train_batch(cfg, seed=100 + step, b=2, s=12)
        if step in nan_at:
            b["inputs_embeds"][0, 1, 2] = float("nan")
        return _on(b, dev)

    loop = ResilientLoop(run_step, state, CheckpointManager(root, keep=2),
                         batch_at, FaultConfig(checkpoint_every=5,
                                               max_retries=2), chaos=chaos)
    rep = loop.run(n_steps)
    _bind(model, loop.state["params"])
    return model, loop.state, rep


def _state_tensors(model, opt) -> list:
    return [t.detach().clone() for t in (
        *model.parameters(), opt.step, *opt.mu.values(), *opt.nu.values())]


def _all_equal(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def train_loop(dev, root) -> dict:
    """The fault-tolerant loop on ``dev``: a crash at step 15 with
    checkpoints every 5 steps ends where an uninterrupted 20-step run
    ends, bit for bit; a NaN batch at step 3 leaves the state as 3 clean
    steps left it, bit for bit."""
    import shutil

    crashes = {15}

    def chaos(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError("simulated preemption")

    shutil.rmtree(root, ignore_errors=True)
    m1, s1, r1 = _lm_loop(dev, root / "crash", 20, chaos)
    m2, s2, r2 = _lm_loop(dev, root / "clean", 20)
    crash_equal = _all_equal(_state_tensors(m1, s1["opt"]),
                             _state_tensors(m2, s2["opt"]))
    check(r1.restores == 1 and r2.restores == 0 and crash_equal,
          f"a crash at step 15 (restores {r1.restores}) does not end where "
          "an uninterrupted run ends")
    m3, s3, _ = _lm_loop(dev, root / "three", 3)
    m4, s4, r4 = _lm_loop(dev, root / "nan", 4, nan_at={3})
    nan_equal = _all_equal(_state_tensors(m3, s3["opt"]),
                           _state_tensors(m4, s4["opt"]))
    check(r4.skipped_nan == 1 and nan_equal,
          "a skipped NaN batch changed the state")
    shutil.rmtree(root, ignore_errors=True)
    return {"crash_restores": r1.restores, "crash_equals_clean": crash_equal,
            "nan_skips": r4.skipped_nan, "nan_skip_state_equal": nan_equal,
            "losses_crash_run": r1.losses[-3:]}


def _loss_and_norm(model, batch) -> tuple:
    """Forward and backward only: (loss, global gradient norm)."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.optim import global_norm

    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    return float(loss.detach()), float(global_norm(grads))


def fro_rel(got: list, want: list) -> float:
    """||got - want|| / ||want||, Frobenius over the lists, in float32."""
    num = sum(float(((g.float() - w.float()) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((w.float() ** 2).sum()) for w in want)
    return math.sqrt(num / den) if den else 0.0


def layer_backward_gaps(m32, m16, tokens) -> dict:
    """Each bf16 block's backward alone against the f32 twin's (the serve
    phase's layer-by-layer practice, applied to gradients): the block's
    input is the twin's f32 stream and its output gradient a fixed
    standard-normal draw, both rounded to bf16 for the bf16 block.  Per
    block, the gaps of its input gradient (``dx``) and of its weights'
    gradients (``dw``, over the block) as ``fro_rel``; beside them the
    rounding floor: the same gaps of an f32 run on the bf16-rounded
    weights, input and output gradient, what the rounding of the operands
    alone moves.  And the head's (final norm, logits, cross-entropy) input
    gradient on the twin's last stream."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import rmsnorm, softmax_cross_entropy
    from repro_torch.models.transformer import _train_caches

    b, s = tokens.shape
    dev = tokens.device
    pos = torch.arange(s, dtype=torch.int32, device=dev)

    def head(m, y):
        y = rmsnorm(y, m.final_norm, m.cfg.norm_eps)
        return softmax_cross_entropy(m.logits(y)[:, :-1], tokens[:, 1:])

    with torch.no_grad():
        xs = [F.embedding(tokens, m32.embed)]
        for i, st in enumerate(_train_caches(m32, b)):
            xs.append(_block(m32, i, xs[-1], pos, st)[0])
    dys = []
    for m in (m32, m16):
        y = xs[-1].to(m.dtype).requires_grad_()
        dys.append(torch.autograd.grad(head(m, y), y)[0])
    rounded = _copy_model(m16, torch.float32, dev)
    gaps = {"head": fro_rel(dys[1:], dys[:1]), "dx": [], "dw": [],
            "floor_dx": [], "floor_dw": []}
    gen = torch.Generator(device=dev).manual_seed(11)
    for i in range(len(m32.blocks)):
        dy = torch.randn(xs[i].shape, generator=gen, device=dev)
        grads = []
        for m, dt in ((m32, None), (m16, torch.bfloat16),
                      (rounded, torch.bfloat16)):
            x, d = (xs[i], dy) if dt is None else (
                xs[i].to(dt).to(m.dtype), dy.to(dt).to(m.dtype))
            x = x.detach().requires_grad_()
            ws = list(m.blocks[i].parameters())
            y = _block(m, i, x, pos, _train_caches(m, b)[i])[0]
            grads.append(torch.autograd.grad(y, [x, *ws], d, allow_unused=True,
                                             materialize_grads=True))
        (dx, *dw), (dx16, *dw16), (dxr, *dwr) = grads
        gaps["dx"].append(fro_rel([dx16], [dx]))
        gaps["dw"].append(fro_rel(dw16, dw))
        gaps["floor_dx"].append(fro_rel([dxr], [dx]))
        gaps["floor_dw"].append(fro_rel(dwr, dw))
    gaps["over_floor"] = max(
        a / f if f else (0.0 if a == 0 else math.inf)
        for a, f in zip(gaps["dx"] + gaps["dw"],
                        gaps["floor_dx"] + gaps["floor_dw"]))
    return gaps


def train_full(dev, arch: str, cfg, root, main_args=()) -> dict:
    """One model at full width: ``launch.train.main`` for 12 steps (loss
    finite and falling; its kernel launches are the fabric tie's), step 1's
    bf16 loss and gradient norm against an f32 twin of the same weights,
    then the step timed (forward, backward, optimizer), its peak memory,
    two identical steps from one state, and one step traced."""
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.convert import reference_decay
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw_init, adamw_update

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"arch": cfg.name}
    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    rep = train_main(["--arch", arch, "--steps", str(TRAIN_STEPS),
                      "--global-batch", str(TRAIN_BATCH), "--seq-len",
                      str(TRAIN_SEQ), "--checkpoint-dir", str(root),
                      "--checkpoint-every", str(10 * TRAIN_STEPS),
                      "--device", str(dev), *main_args])
    sync()
    out["main_s"] = time.perf_counter() - t0
    out["main_launches"] = kernels.launch_counts()
    losses = rep.losses
    check(rep.steps_done == TRAIN_STEPS and len(losses) == TRAIN_STEPS
          and all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{cfg.name}: 12 steps of launch.train.main gave losses {losses}")
    out["losses"] = losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        out["allocated_after_main_bytes"] = torch.cuda.memory_allocated(dev)

    kernels.reset_launch_counts()
    tokens = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                         seed=0).batch_at(0)["tokens"][:, :-1]
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    twin = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    model = _copy_model(twin, torch.bfloat16, dev)  # the same weights
    loss32, norm32 = _loss_and_norm(twin, batch)
    loss16, norm16 = _loss_and_norm(model, batch)
    gaps = layer_backward_gaps(twin, model, batch["tokens"])
    del twin
    gc.collect()
    out.update({"step1_loss_bf16": loss16, "step1_loss_f32": loss32,
                "step1_grad_norm_bf16": norm16, "step1_grad_norm_f32": norm32,
                "bf16_loss_rel": abs(loss16 / loss32 - 1),
                "bf16_grad_norm_rel": abs(norm16 / norm32 - 1),
                "bf16_layer_backward_rel": gaps})
    fam = cfg.family
    check(out["bf16_loss_rel"] <= TRAIN_BF16_LOSS_REL,
          f"{cfg.name}: bf16 step-1 loss {out['bf16_loss_rel']:.3g} from "
          "the f32 twin's")
    check(out["bf16_grad_norm_rel"] <= TRAIN_BF16_GNORM_REL.get(fam, math.inf),
          f"{cfg.name}: bf16 step-1 gradient norm "
          f"{out['bf16_grad_norm_rel']:.3g} from the f32 twin's")
    check(max(gaps["dw"] + gaps["dx"]) <= TRAIN_BF16_LAYER_REL.get(
              fam, math.inf)
          and gaps["over_floor"] <= TRAIN_BF16_OVER_FLOOR
          and gaps["head"] <= TRAIN_BF16_HEAD_REL,
          f"{cfg.name}: a bf16 block's backward alone against the f32 "
          f"twin's: {gaps}")

    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, lr=3e-4, dtype=torch.bfloat16)
    opt = adamw_init(model)
    params = dict(model.named_parameters())
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):  # the first one warms the libraries
        sync()
        t0 = time.perf_counter()
        step(model, opt, batch)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # one step split where make_train_step's parts meet
    sync()
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, batch)
    sync()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    sync()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(loss)), f"{cfg.name}: non-finite loss")
    adamw_update(dict(zip(params, grads)), opt, params, 3e-4,
                 decay=reference_decay(model))
    sync()
    t3 = time.perf_counter()
    del grads, loss
    ms = min(step_ms)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    out.update({"params": n_params, "step_ms": step_ms,
                "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
                "optimizer_ms": (t3 - t2) * 1e3,
                "tokens_per_s": n_tok / (ms / 1e3),
                "model_flop_per_step": 6 * n_params * n_tok})
    if cuda:
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["mfu_bf16"] = 6 * n_params * n_tok / (ms / 1e3) / BF16_FLOP_PER_S

    # two identical steps from one state
    snap = _state_tensors(model, opt)
    step(model, opt, batch)
    first = _state_tensors(model, opt)
    with torch.no_grad():
        for dst, src in zip((*model.parameters(), *opt.mu.values(),
                             *opt.nu.values()),
                            (*snap[:len(params)],
                             *snap[len(params) + 1:])):
            dst.copy_(src)
    opt.step = snap[len(params)].clone()
    step(model, opt, batch)
    second = _state_tensors(model, opt)
    names = [*params, "step", *(f"mu/{n}" for n in params),
             *(f"nu/{n}" for n in params)]
    differ = [n for n, a, b in zip(names, first, second)
              if not torch.equal(a, b)]
    out["repeat_step_bit_equal"] = not differ
    out["repeat_step_differs_in"] = differ[:12]
    del snap, first, second
    # the backward ops the card sums with atomics, each run twice at this
    # step's shapes: equal or not
    emb = model.embed.detach().clone().requires_grad_(True)
    g_out = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                        generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev, dtype=emb.dtype)
    runs = [torch.autograd.grad(F.embedding(batch["tokens"], emb), emb,
                                g_out)[0] for _ in range(2)]
    out["embedding_backward_repeat_equal"] = bool(torch.equal(*runs))
    del runs, emb, g_out
    gc.collect()
    if cuda:
        out["step_trace"] = traced(lambda: step(model, opt, batch))
    out["step_launches"] = kernels.launch_counts()
    del model, opt, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_phase(dev, root, shrink=None, main_args=()) -> dict:
    """The training path: every registered arch at ``reduced()`` card
    against CPU, the card's microbatch, int8, remat and loop checks, then
    ``rwkv6-1.6b`` and ``internvl2-1b`` at full width through
    ``launch.train.main``.  ``shrink`` and ``main_args`` cut the full
    width for a CPU rehearsal only.  The train steps launch none of the
    port's five kernels (``step_launches``); ``main_launches`` are the
    fabric tie's (``make_fabric(...).describe()``)."""
    from repro_torch import kernels
    from repro_torch.configs import get, names

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out = {"phase": "train",
           "reduced": {arch: train_reduced(dev, arch) for arch in names()},
           "microbatches": train_microbatches(dev),
           "int8": train_int8(dev),
           "remat": {arch: train_remat(dev, arch)
                     for arch in TRAIN_REMAT_ARCHS},
           "loop": train_loop(dev, root / "loop")}
    out["reduced_launches"] = kernels.launch_counts()
    out["reduced_seconds"] = time.perf_counter() - t0
    shrink = shrink or (lambda c: c)
    out["full"] = {}
    for arch in TRAIN_FULL:
        t1 = time.perf_counter()
        out["full"][arch] = train_full(dev, arch, shrink(get(arch)),
                                       root / arch, main_args)
        out["full"][arch]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


MESH_BUDGET_S = 60.0
#: The full-width sharded step: ``internvl2-1b`` (attention, MLP and vocab
#: rules all active) at ``launch.train``'s defaults, bf16, on
#: ``make_local_mesh()`` over the card (an NCCL mesh of one rank), two
#: steps from the state a ``mesh=None`` step starts from.
MESH_FULL = "internvl2-1b"
#: One reduced arch per family on the same one-rank card mesh: a train step
#: against the port's CPU step (the train phase's gates), a prefill and a
#: decode step against ``mesh=None`` on the card (the serve phase's logit
#: and cache bounds).
MESH_FAMILIES = ("qwen2.5-32b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
                 "recurrentgemma-2b")
#: The four-rank gloo check on the host's CPU (a (2, 2) mesh, reduced dense
#: arch, float32): the loss rtol 1e-6, every gradient within 1e-5 of its
#: leaf's largest magnitude, the parameters after one AdamW step at lr 1e-3
#: within 3e-4 (tests/test_torch_sharded_steps.py's bounds).
MESH_GLOO_ARCH = "qwen2.5-32b"
MESH_GLOO_GRAD_REL = 1e-5
#: The full-size dry-run cell, traced on the host in a background process
#: (a fake group of 256 ranks, fake tensors, nothing on the card), and the
#: same cell with int8 error feedback in a second one (its peak covers the
#: round trip's gathered runs).
MESH_DRYRUN = ("qwen2.5-32b", "train_4k")
#: Seconds the background checks may still take when the phase waits.
MESH_WAIT_S = 600.0


def _child_env() -> dict:
    import os

    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def mesh_background(root, names=("dryrun", "dryrun_int8", "gloo"),
                    bg=None) -> dict:
    """Start the mesh phase's CPU checks named in ``names`` (adding them to
    ``bg``): the full-size dry-run cell (``python -m
    repro_torch.launch.dryrun``), without and with int8 error feedback, and
    the four-rank gloo check (this script with ``--gloo-check``).  None
    sees the card."""
    root.mkdir(parents=True, exist_ok=True)
    arch, shape = MESH_DRYRUN
    dryrun = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
              arch, "--shape", shape, "--out", str(root / "dryrun"),
              "--force"]
    cmds = {"dryrun": dryrun,
            "dryrun_int8": dryrun + ["--grad-compression", "int8"],
            "gloo": [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--gloo-check", str(root / "gloo.json")]}
    bg = bg or {"root": root, "procs": {}}
    for name in names:
        log = open(root / f"{name}.log", "w")
        bg["procs"][name] = (subprocess.Popen(
            cmds[name], stdout=log, stderr=subprocess.STDOUT,
            env=_child_env(), cwd=str(ROOT)), log, time.perf_counter())
    return bg


def mesh_stop(bg: dict) -> None:
    """Stop whatever of the background checks still runs."""
    for proc, log, _ in bg["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _mesh_wait(bg: dict, name: str) -> dict:
    proc, log, t0 = bg["procs"][name]
    rc = proc.wait(timeout=MESH_WAIT_S)
    log.flush()
    tail = (bg["root"] / f"{name}.log").read_text()[-3000:]
    check(rc == 0, f"the mesh phase's {name} check exited {rc}: {tail}")
    return {"exit": rc, "wall_s": time.perf_counter() - t0}


def _rank_grads(model, batch, mesh, cfg):
    """(loss, {name: gradient}) of the sharded loss, as full values."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.steps import (
        _place_batch,
        _sharder,
        place_model,
        state_shardings,
    )
    from repro_torch.models import loss_fn

    place_model(model, state_shardings(model, mesh)[0])
    params = dict(model.named_parameters())
    with implicit_replication():
        loss, _ = loss_fn(model, _place_batch(batch, mesh, cfg),
                          _sharder(cfg, mesh))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return (float(loss.full_tensor()),
            {n: g.full_tensor() for n, g in zip(params, grads)})


def _gloo_rank(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs import get
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import init_params
        from repro_torch.optim import adamw_init

        cfg = get(MESH_GLOO_ARCH).reduced()
        mesh = make_local_mesh(2, device="cpu")
        batch = train_batch(cfg, seed=3)
        loss, grads = _rank_grads(init_params(cfg, seed=0, device="cpu"),
                                  batch, mesh, cfg)
        model = init_params(cfg, seed=0, device="cpu")
        _, _, m = make_train_step(cfg, mesh=mesh, lr=TRAIN_LR,
                                  dtype=torch.float32)(
            model, adamw_init(model), batch)
        params = {n: p.full_tensor() for n, p in model.named_parameters()}
        if rank == 0:
            torch.save({"loss": loss, "grads": grads,
                        "step_loss": float(m["loss"]), "params": params,
                        "mesh": list(mesh.shape)}, out)
    finally:
        dist.destroy_process_group()


def gloo_check(out_path: str) -> None:
    """Four gloo ranks on this host's CPU at (2, 2), one reduced dense arch:
    the sharded loss, gradients and one AdamW step against the unsharded
    port; writes the gaps and the verdict as JSON."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    torch.set_num_threads(1)
    cfg = get(MESH_GLOO_ARCH).reduced()
    batch = train_batch(cfg, seed=3)
    model = init_params(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True,
        materialize_grads=True)))
    model = init_params(cfg, seed=0, device="cpu")
    _, _, m = make_train_step(cfg, lr=TRAIN_LR, dtype=torch.float32)(
        model, adamw_init(model), batch)
    with tempfile.TemporaryDirectory() as tmp:
        got_path = f"{tmp}/rank0.pt"
        mp.spawn(_gloo_rank, args=(4, f"{tmp}/store", got_path), nprocs=4,
                 join=True)
        got = torch.load(got_path, weights_only=False)
    out = {"check": "cpu", "backend": "gloo", "ranks": 4,
           "mesh": got["mesh"], "arch": cfg.name,
           "torch": torch.__version__,
           "loss_rel": abs(got["loss"] / float(loss) - 1),
           "step_loss_rel": abs(got["step_loss"] / float(m["loss"]) - 1),
           "grad_rel": leaf_rel(got["grads"], grads),
           "param_max_abs_err": max(
               float((got["params"][n] - p.detach()).abs().max())
               for n, p in model.named_parameters()),
           "seconds": time.perf_counter() - t0}
    out["ok"] = (out["loss_rel"] <= TRAIN_LOSS_RTOL
                 and out["step_loss_rel"] <= TRAIN_LOSS_RTOL
                 and out["grad_rel"] <= MESH_GLOO_GRAD_REL
                 and out["param_max_abs_err"] <= TRAIN_PARAM_ATOL)
    pathlib.Path(out_path).write_text(json.dumps(out))


def _state_equal(m0, o0, m1, o1) -> dict:
    """Bit-for-bit comparison of a plain model and ``OptState`` against a
    sharded one (full values); the largest gaps beside it."""
    import torch

    out = {"params": True, "mu": True, "nu": True, "max_abs_err": 0.0}
    for n, a in m0.named_parameters():
        b = m1.get_parameter(n).full_tensor()
        for key, x, y in (("params", a, b),
                          ("mu", o0.mu[n], o1.mu[n].full_tensor()),
                          ("nu", o0.nu[n], o1.nu[n].full_tensor())):
            if not torch.equal(x, y):
                out[key] = False
                out["max_abs_err"] = max(
                    out["max_abs_err"],
                    float((x.float() - y.float()).abs().max()))
    return out


def mesh_full(dev, mesh, shrink=None) -> dict:
    """``MESH_FULL`` at full width in bf16: the sharded train step on
    ``mesh`` against ``mesh=None`` from the same state (two steps each),
    then each timed (best of 3), with the sharded step's peak memory and
    the port's kernel launches in its run."""
    import gc

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cuda = dev.type == "cuda"
    cfg = (shrink or (lambda c: c))(get(MESH_FULL))
    tokens = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                         seed=0).batch_at(0)["tokens"][:, :-1]
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    runs = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        model = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        opt = adamw_init(model)
        step = make_train_step(cfg, mesh=m, lr=3e-4, dtype=torch.bfloat16)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        losses = [float(step(model, opt, batch)[2]["loss"])
                  for _ in range(2)]
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        runs[name] = (model, opt, losses, launches, peak, step)
    (m0, o0, l0, _, _, s0), (m1, o1, l1, launches, peak, s1) = (
        runs["unsharded"], runs["sharded"])
    eq = _state_equal(m0, o0, m1, o1)
    out = {"arch": cfg.name, "params": sum(p.numel() for p in m0.parameters()),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": "bfloat16",
           "remat": cfg.remat, "mesh": list(mesh.shape),
           "losses_unsharded": l0, "losses_sharded": l1,
           "bit_equal": eq, "launches": launches,
           "peak_allocated_bytes": peak}
    check(l0 == l1 and eq["params"] and eq["mu"] and eq["nu"],
          f"{cfg.name}: the one-rank sharded step left the unsharded step's "
          f"state: losses {l0} / {l1}, {eq}")
    check(not any(launches.values()),
          f"the sharded step launched kernels {launches}")
    for name, model, opt, step in (("unsharded", m0, o0, s0),
                                   ("sharded", m1, o1, s1)):
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            step(model, opt, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_step_ms"] = times
        out[f"{name}_best_ms"] = min(times)
    out["sharded_over_unsharded"] = (out["sharded_best_ms"]
                                     / out["unsharded_best_ms"])
    del runs, m0, m1, o0, o1
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def mesh_reduced(dev, mesh, arch: str) -> dict:
    """One reduced arch in float32 on the one-rank mesh: a sharded train
    step against the port's CPU step (the train phase's gates), and a
    sharded prefill and decode step (caches placed by ``cache_shardings``)
    against ``mesh=None`` on ``dev``."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get(arch).reduced()
    cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = _copy_model(cpu, torch.float32, dev)
    batch = train_batch(cfg, seed=3)
    _, oc, mc = make_train_step(cfg, lr=TRAIN_LR, dtype=torch.float32)(
        cpu, adamw_init(cpu), batch)
    _, og, mg = make_train_step(cfg, mesh=mesh, lr=TRAIN_LR,
                                dtype=torch.float32)(
        card, adamw_init(card), _on(batch, dev))
    full = lambda d: {n: t.full_tensor() for n, t in d.items()}  # noqa: E731
    out = {"loss_rel": abs(float(mg["loss"]) / float(mc["loss"]) - 1),
           "grad_norm_rel": abs(float(mg["grad_norm"])
                                / float(mc["grad_norm"]) - 1),
           "mu_rel": leaf_rel(full(og.mu), oc.mu),
           "nu_rel": leaf_rel(full(og.nu), oc.nu),
           "param_max_abs_err": max(
               float((card.get_parameter(n).full_tensor().cpu()
                      - p.detach()).abs().max())
               for n, p in cpu.named_parameters())}
    rel = train_rel(arch)
    check(out["loss_rel"] <= TRAIN_LOSS_RTOL and out["grad_norm_rel"] <= rel
          and out["mu_rel"] <= rel and out["nu_rel"] <= 2 * rel
          and out["param_max_abs_err"] <= TRAIN_PARAM_ATOL,
          f"{arch}: the sharded card step against the CPU step: {out}")

    plain = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    placed = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, SERVE_REDUCED_PROMPT),
                           generator=g).to(dev)
    p0 = make_prefill_step(cfg, dtype=torch.float32)
    p1 = make_prefill_step(cfg, mesh=mesh, dtype=torch.float32)
    d0 = make_decode_step(cfg, dtype=torch.float32)
    d1 = make_decode_step(cfg, mesh=mesh, dtype=torch.float32)
    l0, c0 = p0(plain, {"tokens": prompt})
    l1, c1 = p1(placed, {"tokens": prompt})
    tok = torch.argmax(l0[:, :cfg.vocab_size], -1)
    gaps = [_close_or_fail(l1.full_tensor(), l0, SERVE_LOGIT_TOL,
                           f"{arch}: sharded prefill logits")]
    l0, c0 = d0(plain, c0, tok, SERVE_REDUCED_PROMPT)
    l1, c1 = d1(placed, c1, tok, SERVE_REDUCED_PROMPT)
    gaps.append(_close_or_fail(l1.full_tensor(), l0, SERVE_LOGIT_TOL,
                               f"{arch}: sharded decode logits"))
    cache_gap = max(_close_or_fail(b[k].full_tensor(), a[k], SERVE_CACHE_TOL,
                                   f"{arch}: sharded cache {k}")
                    for a, b in zip(c0, c1) for k in a)
    out.update({"prefill_logit_rel": gaps[0], "decode_logit_rel": gaps[1],
                "cache_rel": cache_gap,
                "cache_placements": sorted({f"{k}:{b[k].placements}"
                                            for b in c1 for k in b})})
    return out


def mesh_phase(dev, bg: dict, shrink=None) -> dict:
    """The mesh half of the model stack: the full-width sharded train step
    on the one-rank card mesh, one reduced arch per family sharded on it,
    then the two background checks' results (four gloo ranks on the CPU;
    the full-size dry-run cell)."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    made = not dist.is_initialized()
    mesh = make_local_mesh(device=dev)
    try:
        out = {"phase": "mesh", "backend": dist.get_backend(),
               "mesh": list(mesh.shape), "torch": torch.__version__}
        kernels.reset_launch_counts()
        out["full"] = mesh_full(dev, mesh, shrink)
        out["reduced"] = {arch: mesh_reduced(dev, mesh, arch)
                          for arch in MESH_FAMILIES}
        out["launches"] = kernels.launch_counts()
        out["card_seconds"] = time.perf_counter() - t0
    finally:
        if made:
            dist.destroy_process_group()
    out["gloo_cpu_check"] = {**_mesh_wait(bg, "gloo"), **json.loads(
        (bg["root"] / "gloo.json").read_text())}
    check(out["gloo_cpu_check"]["ok"],
          f"the four-rank gloo check: {out['gloo_cpu_check']}")
    card_bytes = (torch.cuda.get_device_properties(dev).total_memory
                  if dev.type == "cuda" else None)
    for name, tag in (("dryrun", ""), ("dryrun_int8", "__int8")):
        out[name] = _dryrun_cell(bg, name, tag, card_bytes)
    out["seconds"] = time.perf_counter() - t0
    return out


def _dryrun_cell(bg: dict, name: str, tag: str, card_bytes) -> dict:
    """The background dry-run cell ``name``'s record; its peak a rank must
    fit the card."""
    out = _mesh_wait(bg, name)
    arch, shape = MESH_DRYRUN
    cell = json.loads((bg["root"] / "dryrun" /
                       f"{arch}__{shape}__pod16x16{tag}.json").read_text())
    check(cell["status"] == "ok", f"the dry-run cell: {cell}")
    out.update({
        "cell": f"{arch} x {shape} x {cell['mesh']}",
        "grad_compression": cell.get("grad_compression", "none"),
        "n_devices": cell["n_devices"], "microbatches": cell["microbatches"],
        "trace_s": cell["trace_s"],
        "argument_bytes_per_rank": cell["memory"]["argument_bytes"],
        "peak_bytes_per_rank": cell["memory"]["peak_bytes"],
        "card_bytes": card_bytes,
        "flops_per_device": cell["op_stats"]["flops_per_device"],
        "hbm_bytes_per_device": cell["op_stats"]["hbm_bytes_per_device"],
        "wire_bytes_per_device": cell["op_stats"]["wire_bytes_per_device"],
        "useful_flops_ratio": cell["useful_flops_ratio"],
        "roofline": cell["roofline"],
        "top_collectives": cell["op_stats"]["collectives"][:3]})
    if card_bytes is not None:
        check(cell["memory"]["peak_bytes"] < card_bytes,
              f"the dry-run cell's peak {cell['memory']['peak_bytes']} B a "
              f"rank does not fit the card's {card_bytes} B")
    return out


#: The ``ir`` and ``examples`` phases together aim under this.
IR_EXAMPLES_BUDGET_S = 30.0
#: Each MW solve of the expand-cluster chain on the card against the same
#: solve on the CPU from the same path system and warm start.  The card's
#: dense kernel and the CPU's plain product sum in different orders, and
#: the anneal amplifies that.  At the example's 200 iterations the spread
#: between two summation orders is wider than the 5e-3 that
#: ``tests/test_torch_flow.py`` states for 400: the phase prints the CPU's
#: own dense-against-gather gap on each solve (``cpu_order_rel``), which
#: this bound must cover.  Independently of any order, no MW alpha may
#: exceed the path LP's optimum (MW's best iterate is a feasible routing).
#: The chain's own alphas are not held to it: each solve starts from the
#: previous one's rates, so one solve's drift moves the next one's start
#: (``chain_alpha_max_rel`` reports the gap).
EXAMPLE_ALPHA_RTOL = 1e-2


def ir_phase(dev) -> dict:
    """The dispatch-level audit (``python -m repro_torch.analysis ir``) on
    the card over every registered case: no finding beyond the recorded
    exemptions, every kernel, wrapper and dense solver case moved the launch
    counters it names (the kernels launch through ``ctypes``, unseen by the
    dispatcher), each case's aten ops and launches printed; then RT-1: one
    MW batch run a second time inside ``retrace.track_compiles()`` builds
    no kernel, leaves ``solver_cache_sizes()`` as it was and equals the
    first run bit for bit."""
    import numpy as np

    from repro_torch.analysis import irlint, retrace
    from repro_torch.analysis.registry import registered_entries
    from repro_torch.core import mw_concurrent_flow_batch
    from repro_torch.core.flow import _audit_systems

    t0 = time.perf_counter()
    findings, rows = irlint.audit_entries(registered_entries(), dev)
    check(not findings, "ir audit on the card: "
          + "; ".join(str(f) for f in findings))
    for row in rows:
        for name in row["kernels"]:
            check(row["launches"].get(name, 0) > 0,
                  f"{row['entry']}[{row['case']}] launched no {name} kernel")
    audit_s = time.perf_counter() - t0
    systems = list(_audit_systems())
    first = mw_concurrent_flow_batch(systems, iters=50, device=dev)
    sizes = retrace.solver_cache_sizes()
    with retrace.track_compiles() as builds:
        again = mw_concurrent_flow_batch(systems, iters=50, device=dev)
    check(builds.count == 0,
          f"RT-1: a second same-bucket MW batch built {builds.events}")
    check(retrace.solver_cache_sizes() == sizes,
          "RT-1: solver_cache_sizes() changed on a same-bucket rerun")
    check(all(a.alpha == b.alpha and np.array_equal(a.rates, b.rates)
              for a, b in zip(first, again)),
          "RT-1: the same-bucket rerun differs from the first run")
    return {"phase": "ir", "findings": len(findings), "cases": [
        {k: r[k] for k in ("entry", "case", "kind", "aten_ops", "launches",
                           "exempt")} for r in rows],
        "audit_seconds": audit_s, "rt1_builds": builds.count,
        "rt1_backend": first[0].method,
        "seconds": time.perf_counter() - t0}


def examples_phase(dev, root) -> dict:
    """``examples/expand_cluster_torch.py`` at the example's own sizes (a
    64-pod Jellyfish fabric grown to 80 pods in 4-pod tranches with MW at
    200 iterations warm-started across each delta, 5 % of its links
    failed, a pod lost, the ring re-embedded, the mesh re-planned, a
    checkpoint restored) on the card, held against a CPU run of the same
    code: descriptions, path systems (by digest), spliced shares, ring,
    mesh plans and the restore equal; each of the card's MW solves within
    ``EXAMPLE_ALPHA_RTOL`` of the same solve on the CPU from the same path
    system and warm start."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.core import lp_concurrent_flow, mw_concurrent_flow

    path = ROOT / "examples" / "expand_cluster_torch.py"
    spec = importlib.util.spec_from_file_location("expand_cluster_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    runs, secs = {}, {}
    for key, name in (("card", dev.type), ("cpu", "cpu")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            runs[key] = example.main(["--device", name, "--checkpoint-dir",
                                      str(root / key)])
        secs[key] = time.perf_counter() - t0
    gpu, cpu = runs["card"], runs["cpu"]
    for key in ("describe", "mesh", "replan", "ring", "restored"):
        check(gpu[key] == cpu[key], f"examples: {key} differs on the card: "
              f"{gpu[key]} != {cpu[key]}")
    check(gpu["restored"]["equal"], "examples: the restore differs")
    chain = 0.0
    for g, c in zip(gpu["routing"], cpu["routing"], strict=True):
        for key in ("switches", "n_paths", "digest", "spliced"):
            check(g[key] == c[key], f"examples: {key} differs on the card at "
                  f"{g['switches']} switches: {g[key]} != {c[key]}")
        chain = max(chain, abs(g["alpha"] - c["alpha"]) / abs(c["alpha"]))
    rows = []
    for g, solve in zip(gpu["routing"], gpu["solves"], strict=True):
        ps, alpha = solve["system"], solve["flow"].alpha
        ref, alt = (mw_concurrent_flow(ps, iters=200, warm=solve["warm"],
                                       backend=b, device="cpu")
                    for b in ("dense", "gather"))
        lp = lp_concurrent_flow(ps).alpha
        rel = abs(alpha - ref.alpha) / abs(ref.alpha)
        check(rel <= EXAMPLE_ALPHA_RTOL,
              f"examples: MW alpha on the card at {g['switches']} switches "
              f"{rel:.2e} from the CPU's from the same start, over "
              f"{EXAMPLE_ALPHA_RTOL}")
        check(alpha <= lp * (1 + 1e-6), f"examples: MW alpha {alpha} on the "
              f"card at {g['switches']} switches above the LP optimum {lp}")
        rows.append({**g, "backend": solve["flow"].method,
                     "cpu_alpha_same_start": ref.alpha, "alpha_rel": rel,
                     "cpu_order_rel": abs(alt.alpha - ref.alpha)
                     / abs(ref.alpha), "lp_alpha": lp})
    return {"phase": "examples", "example": "examples/expand_cluster_torch.py",
            "routing": rows, "ring": gpu["ring"],
            "chain_alpha_max_rel": chain,
            "card_seconds": secs["card"], "cpu_seconds": secs["cpu"]}


def bisection_k(elapsed: float, probes: int, probe_s: float) -> tuple:
    """The fat-tree k of a bisection that takes about ``probes`` probes of
    ``probe_s`` seconds each: K_FULL while that fits what is left of the
    time budget, else 16; and why."""
    need = elapsed + probes * probe_s
    k = K_FULL if need < TIME_BUDGET_S else 16
    return k, (f"{elapsed:.1f} s elapsed + {probes} x probe {probe_s:.2f} s "
               f"{'<' if k == K_FULL else '>='} budget {TIME_BUDGET_S:.0f} s")


def pipeline_bisection(run: PathRun, k: int, best_seq: int) -> dict:
    """The wave bisection (``wave_levels=2``, its build units through
    ``stream_builds``) with the build pipeline on and off; both must give
    the sequential search's server count.  The batched solve is pinned to
    ``dense`` so every wave takes the backend the sequential probes took."""
    from repro_torch import capacity, obs
    from repro_torch.core import fattree_equipment, set_build_pipeline
    from repro_torch.core.routing import clear_routing_cache

    eq = fattree_equipment(k)
    lo, hi = eq["servers"] // 2, 2 * eq["servers"]
    out = {"phase": "bisection_pipeline", "k": k, "wave_levels": 2}
    prev = set_build_pipeline(True)
    try:
        for flag, tag in ((True, "on"), (False, "off")):
            set_build_pipeline(flag)
            clear_routing_cache()
            c0 = {c: obs.counter(f"pipeline/{c}").to_value()
                  for c in ("stall_s", "overlap_s", "builds")}
            best, secs = run(f"bisection_wave_{tag}", lambda: (
                capacity.max_servers_at_full_capacity(
                    eq["switches"], eq["ports_per_switch"], lo=lo, hi=hi,
                    seeds=(0,), wave_levels=2, method="mw",
                    mw_backend="dense", device=run.dev)))
            out[tag] = {"servers": best, "seconds": secs,
                        **{f"pipeline/{c}": obs.counter(
                            f"pipeline/{c}").to_value() - v
                           for c, v in c0.items()},
                        "launches": run.launches[f"bisection_wave_{tag}"]}
    finally:
        set_build_pipeline(prev)
    check(out["on"]["servers"] == out["off"]["servers"] == best_seq,
          f"wave bisection with the pipeline on {out['on']['servers']} / off "
          f"{out['off']['servers']} != sequential {best_seq}")
    return out


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
        set_build_pipeline,
        update_path_system,
    )
    from repro_torch.core import routing
    from repro_torch.core.flow import _empty_path_system, dense_incidence
    from repro_torch.core.metrics import apsp_hops_blocked
    from repro_torch.core.routing import clear_routing_cache
    from repro_torch.kernels import _build, admission as adm_mod, ops
    from repro_torch.kernels.admission import admission, admission_ref
    from repro_torch.kernels.congestion import congestion, congestion_ref
    from repro_torch.kernels.minplus import (
        INT16_INF,
        launch_plan,
        minplus,
        minplus_hops,
        minplus_hops_ref,
        minplus_ref,
        pair_rate,
    )
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

    def device_ms(fn, reps: int, kernels_named=None,
                  warm: bool = True) -> tuple[float, str]:
        """Mean device milliseconds per call of ``fn()``, and the timer.

        From the profiler: with ``kernels_named``, the sum over those
        kernels (each launched once per call) of each kernel's mean time
        per recorded launch; without, every device operation ``fn``
        launched (runtime API entries excluded), divided by ``reps``.
        CUPTI tracing sometimes records no device activity for a session;
        then a second session is tried, and if that sees none either the
        time is the stream's time per call from CUDA events (``sync_time``,
        host launch overhead included), and the timer says so.  ``warm``
        makes one call first (a caller that already made one may skip it)."""
        if warm:
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
    # the compiler's report of both min-plus forms (built in this run)
    mp_log = _build.BUILD_LOG.get("minplus", {}).get("log")
    emit({"phase": "ptxas", "minplus": (
        ptxas_report(mp_log, ("minplus_f32_kernel", "minplus_hops_kernel"))
        if mp_log is not None else "not built in this run")})

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

    mp_rng = np.random.default_rng(14)

    def rng_hops(rows, cols):
        """Hop counts 0..8 with a fifth of the entries +inf."""
        x = mp_rng.integers(0, 9, size=(rows, cols)).astype(np.float32)
        x[mp_rng.random((rows, cols)) < 0.2] = np.inf
        return x

    results = {}
    # the card's add-min pair rates: DPX bounds the int16 form, and the
    # float32 pair is held beside the data sheet's rate
    rates = {f: pair_rate(f, device=dev) for f in ("dpx", "f32")}
    dpx_rate = rates["dpx"]

    def to_hops(t):
        return torch.where(torch.isfinite(t), t, float(INT16_INF)).to(
            torch.int16)

    # min-plus: the first APSP squaring of the probe topology (720 x 720),
    # float32 (+inf) and the int16 form the APSP driver squares (sentinel)
    a = torch.from_numpy(top.adjacency()).to(dev)
    d0 = torch.where(a > 0, 1.0, float("inf")).to(torch.float32)
    d0.fill_diagonal_(0.0)
    h0 = to_hops(d0)
    check(torch.equal(minplus(d0, d0), minplus_ref(d0, d0)),
          "min-plus kernel differs from plain")
    check(torch.equal(minplus_hops(h0, h0), minplus_hops_ref(h0, h0)),
          "int16 min-plus kernel differs from plain")
    # ragged shapes with +inf / sentinel entries, both forms
    for m_, k_, n_ in ((1, 1, 1), (65, 33, 130), (7, 300, 5),
                       (721, 333, 1000)):
        x = torch.from_numpy(rng_hops(m_, k_)).to(dev)
        y = torch.from_numpy(rng_hops(k_, n_)).to(dev)
        check(torch.equal(minplus(x, y), minplus_ref(x, y)),
              f"min-plus kernel differs from plain at {(m_, k_, n_)}")
        hx, hy = to_hops(x), to_hops(y)
        hx[0, 0] = -1  # a negative entry loads as 0 in both versions
        check(torch.equal(minplus_hops(hx, hy), minplus_hops_ref(hx, hy)),
              f"int16 min-plus kernel differs from plain at {(m_, k_, n_)}")
    n = d0.shape[0]
    mp_names = ["minplus_f32_kernel", "minplus_reduce_kernel"]
    hops_names = ["minplus_hops_kernel", "minplus_reduce_kernel"]
    results["minplus"] = {
        "max_abs_err": 0.0, "shape": [n, n, n],
        **minplus_bound_ms(4.0 * 3 * n * n, float(n) ** 3, dpx_rate),
        **timings(lambda: minplus(d0, d0), mp_names,
                  lambda: minplus_ref(d0, d0), None, 20),
    }
    results["minplus_hops"] = {
        "max_abs_err": 0.0, "shape": [n, n, n],
        **minplus_bound_ms(2.0 * 3 * n * n, float(n) ** 3, dpx_rate),
        **timings(lambda: minplus_hops(h0, h0), hops_names,
                  lambda: minplus_hops_ref(h0, h0), None, 20),
    }
    # the planned split's product and reduction, each timed alone from the
    # same wrapper calls
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for key, fn_, names, hops in (
            ("minplus", lambda: minplus(d0, d0), mp_names, False),
            ("minplus_hops", lambda: minplus_hops(h0, h0), hops_names, True)):
        plan = launch_plan(n, n, n, n_sm, hops=hops)
        results[key]["plan"] = {k_: plan[k_] for k_ in ("splits", "blocks")}
        results[key]["ms_by_kernel"] = {
            n_: device_ms(fn_, 20, [n_])[0]
            for n_ in names[:1 + (plan["splits"] > 1)]}
    results["minplus_rates"] = {
        "dpx_pairs_per_s": dpx_rate, "f32_pairs_per_s": rates["f32"],
        "f32_data_sheet_pairs_per_s": FP32_PAIRS_PER_S}
    del a, d0, h0

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
    # solver pads it (3 matrices + 1 empty filler, bucketed envelope, each
    # member's padding sentinel hitting its column n_slots)
    batch = PathSystemBatch.from_systems(systems + [_empty_path_system()])
    Bt, Pb, Sb = batch.n_batch, batch.p_max, batch.s_max
    b3 = torch.zeros((Bt, Pb, Sb), dtype=torch.float32, device=dev)
    pe3 = torch.from_numpy(batch.path_edges).to(dev)
    for i in range(Bt):
        b3[i] = dense_incidence(pe3[i], Sb)
    r3 = torch.from_numpy(rng.random((Bt, Pb), np.float32)).to(dev)
    w3 = torch.from_numpy(rng.random((Bt, Sb), np.float32) / Sb).to(dev)
    # the whole stack, no extents: each member equals the single call on it
    l_k, c_k = congestion(b3, r3, w3)
    l_p, c_p = congestion_ref(b3, r3, w3)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-9)
    err_full = max(float((l_k - l_p).abs().max()),
                   float((c_k - c_p).abs().max()))
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
    # the solver's call: each member over its real extent (P_b, S_b), the
    # filler member (0, 0); the kernel reads none of the padding
    ext = (batch.n_paths, [ps.n_slots for ps in batch.systems])
    l_k, c_k = congestion(b3, r3, w3, extents=ext)
    l_p, c_p = congestion_ref(b3, r3, w3, extents=ext)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-9)
    err3 = max(float((l_k - l_p).abs().max()), float((c_k - c_p).abs().max()),
               err_full)
    for i, (pi, si) in enumerate(zip(*ext)):
        check(not l_k[i, si:].any() and not c_k[i, pi:].any(),
              f"congestion member {i}: non-zero output beyond its extents")
        if pi == 0:
            check(not l_k[i].any() and not c_k[i].any(),
                  f"congestion filler member {i}: outputs are not all zero")
            continue
        l1, c1 = congestion(b3[i, :pi, :si].contiguous(),
                            r3[i, :pi].contiguous(), w3[i, :si].contiguous())
        check(torch.equal(l1, l_k[i, :si]) and torch.equal(c1, c_k[i, :pi]),
              f"congestion member {i} over its extents differs from the "
              "single call on its unpadded incidence")
    # the bound counts the three real members' incidences, which is what
    # the call with extents reads; the call without reads the whole stack
    real_cells = sum(ps.n_paths * ps.n_slots for ps in systems)
    real_bytes = 4.0 * sum(ps.n_paths * ps.n_slots + 2 * ps.n_paths
                           + 2 * ps.n_slots for ps in systems)
    b_ms, b_by = bound_ms(real_bytes, 2.0 * real_cells)
    padded_bytes = 4.0 * Bt * (Pb * Sb + 2 * Pb + 2 * Sb)
    pad_ms, _ = bound_ms(padded_bytes, 2.0 * Bt * Pb * Sb)
    full_ms, full_timer = device_ms(lambda: congestion(b3, r3, w3), 10,
                                    cong_names)
    results["congestion_batch"] = {
        "max_abs_err": err3, "bound_ms": b_ms, "bound_by": b_by,
        "extents": [list(map(int, ext[0])), list(map(int, ext[1]))],
        "shape": [Bt, Pb, Sb], "stack_bytes_read": real_bytes,
        "full_stack_bytes": padded_bytes,
        "padding_share": 1.0 - real_bytes / padded_bytes,
        "full_stack_ms": full_ms, "full_stack_timer": full_timer,
        "full_stack_bound_ms": pad_ms,
        **timings(lambda: congestion(b3, r3, w3, extents=ext), cong_names,
                  lambda: congestion_ref(b3, r3, w3, extents=ext),
                  lambda: [(torch.mv(b3[i, :pi, :si].T, r3[i, :pi]),
                            torch.mv(b3[i, :pi, :si], w3[i, :si]))
                           for i, (pi, si) in enumerate(zip(*ext))], 10),
    }
    del b1, b3, l_k, c_k, l_p, c_p, pe3
    torch.cuda.empty_cache()

    # matmul: the spectral path's A @ Q, the RRG(8192, 48, 36) adjacency of
    # phase 3 times the column-major Q that torch.linalg.qr returns for an
    # 8192 x 8 block; float32 throughout (TF32 is off, set above, so the
    # plain and library products are full float32 too).  N <= 16 runs the
    # narrow row-band kernel, wider products the 64 x 64 tile kernel.
    narrow_names, tile_names = ["matmul_narrow_kernel"], ["matmul_kernel"]
    rrg = jellyfish(8192, 48, 36, seed=0)
    adj = rrg.adjacency()
    a_rrg = torch.from_numpy(adj).to(dev)

    def q_block(rows, n, dtype=torch.float32):
        q, _ = torch.linalg.qr(torch.from_numpy(
            rng.standard_normal((rows, n))).to(dev, dtype))
        return q

    q8 = q_block(adj.shape[0], SPECTRAL_BLOCK)
    got = matmul(a_rrg, q8)
    want = matmul_ref(a_rrg, q8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err_mm = float((got - want).abs().max())
    # the narrow kernel at N = 1, 8, 16 (16-byte copies), and at an odd K
    # (8191: single-element copies of A and of Q)
    narrow_err = {}
    for n in (1, 8, 16):
        q = q_block(adj.shape[0], n)
        for label, a_, q_ in ((f"n{n}", a_rrg, q),
                              (f"n{n}_k8191", a_rrg[:, :8191],
                               q_block(8191, n))):
            g, w_ = matmul(a_, q_), matmul_ref(a_, q_)
            torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
            narrow_err[label] = float((g - w_).abs().max())
    # one square float32 shape (tile kernel) and float64 on both kernels
    sq = [torch.from_numpy(rng.random((1024, 1024), np.float32)).to(dev)
          for _ in range(2)]
    got_sq, want_sq = matmul(sq[0], sq[1]), matmul_ref(sq[0], sq[1])
    torch.testing.assert_close(got_sq, want_sq, rtol=1e-5, atol=1e-5)
    f64 = [torch.from_numpy(rng.standard_normal(s)).to(dev)
           for s in ((1000, 700), (700, 130))]
    got_64, want_64 = matmul(*f64), matmul_ref(*f64)
    torch.testing.assert_close(got_64, want_64, rtol=1e-12, atol=1e-12)
    a792_64 = torch.from_numpy(rng.standard_normal((792, 792))).to(dev)
    q792_64 = q_block(792, SPECTRAL_BLOCK, torch.float64)
    got_n64, want_n64 = matmul(a792_64, q792_64), matmul_ref(a792_64, q792_64)
    torch.testing.assert_close(got_n64, want_n64, rtol=1e-12, atol=1e-12)
    nm, km = a_rrg.shape
    # one FMA per (i, j, k); A read once, Q read once, C written once
    b_ms, b_by = bound_ms(4.0 * (nm * km + 2 * km * SPECTRAL_BLOCK),
                          1.0 * nm * km * SPECTRAL_BLOCK)
    results["matmul"] = {
        "max_abs_err": err_mm, "bound_ms": b_ms, "bound_by": b_by,
        "shape": [nm, km, SPECTRAL_BLOCK],
        "narrow_max_abs_err": narrow_err,
        "square_1024_max_abs_err": float((got_sq - want_sq).abs().max()),
        "f64_max_abs_err": float((got_64 - want_64).abs().max()),
        "f64_narrow_max_abs_err": float((got_n64 - want_n64).abs().max()),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        **timings(lambda: matmul(a_rrg, q8), narrow_names,
                  lambda: matmul_ref(a_rrg, q8),
                  lambda: torch.matmul(a_rrg, q8), 50),
    }
    sq_ms, _ = device_ms(lambda: matmul(sq[0], sq[1]), 10, tile_names)
    results["matmul"]["square_1024_ms"] = sq_ms
    # the expansion path's shape: the 792-switch adjacency @ the
    # column-major Q of an 8-wide block
    a792 = torch.from_numpy(
        jellyfish(EXP_SWITCHES + EXP_STEPS * EXP_STEP_SWITCHES, EXP_PORTS,
                  EXP_NET, seed=0).adjacency()).to(dev)
    q792 = q_block(a792.shape[0], SPECTRAL_BLOCK)
    torch.testing.assert_close(matmul(a792, q792), matmul_ref(a792, q792),
                               rtol=1e-5, atol=1e-5)
    n792 = a792.shape[0]
    b_ms792, b_by792 = bound_ms(
        4.0 * (n792 * n792 + 2 * n792 * SPECTRAL_BLOCK),
        1.0 * n792 * n792 * SPECTRAL_BLOCK)
    results["matmul_792"] = {
        "shape": [n792, n792, SPECTRAL_BLOCK], "bound_ms": b_ms792,
        "bound_by": b_by792,
        **timings(lambda: matmul(a792, q792), narrow_names,
                  lambda: matmul_ref(a792, q792),
                  lambda: torch.matmul(a792, q792), 50),
    }
    del got, want, sq, got_sq, want_sq, f64, got_64, want_64, a792, q792
    del a792_64, q792_64, got_n64, want_n64
    emit({"phase": "kernel_checks", "results": results})

    # ---- 3. APSP of RRG(8192, 48, 36) on the card -------------------------- #
    # the driver's own form (int16 at this size), then the float32 kernel
    # through the dense float backend (one whole-matrix product a squaring,
    # the same number of squarings), brought to the canonical int16 form
    def apsp_f32(adj_):
        d = ops.apsp_minplus(adj_, device=dev)
        return torch.where(torch.isfinite(d), d, float(INT16_INF)).to(
            torch.int16).cpu().numpy()

    launches = {}
    apsp_s = {}
    dists = {}
    for path, run_apsp in (
            ("apsp", lambda: ops.apsp_minplus_blocked(adj, device=dev)),
            ("apsp_f32", lambda: apsp_f32(adj))):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dists[path] = run_apsp()
        apsp_s[path] = time.perf_counter() - t0
        launches[path] = kernels.launch_counts()
    t0 = time.perf_counter()
    want = apsp_hops_blocked(adj)
    bfs_s = time.perf_counter() - t0
    check(np.array_equal(dists["apsp"], want),
          "RRG(8192) min-plus APSP != host BFS")
    check(np.array_equal(dists["apsp_f32"], want),
          "RRG(8192) float32 min-plus APSP != host BFS")
    # the first squaring of the APSP (one-hop matrix: 0 diagonal, 1 per
    # edge, no path elsewhere) in each form, against its plain version (run
    # once each at this size: 8192 one-column strips)
    nn = adj.shape[0]
    dfull = torch.where(torch.from_numpy(adj).to(dev) > 0, 1.0,
                        float("inf")).to(torch.float32)
    dfull.fill_diagonal_(0.0)
    hfull = to_hops(dfull)
    squaring = {}
    for form, kern, plain, x, names, nbytes in (
            ("f32", minplus, minplus_ref, dfull, mp_names, 4.0),
            ("hops", minplus_hops, minplus_hops_ref, hfull, hops_names, 2.0)):
        got = kern(x, x)
        ref = plain(x, x)
        check(torch.equal(got, ref),
              f"{form} min-plus kernel differs from plain at 8192^3")
        del got
        ms, timer = device_ms(lambda: kern(x, x), 3, names)
        plain_ms, plain_timer = device_ms(lambda: plain(x, x), 1, warm=False)
        squaring[form] = {
            "ms": ms, "timer": timer,
            "call_ms": sync_time(lambda: kern(x, x), 3),
            "plain_ms": plain_ms, "plain_timer": plain_timer,
            **minplus_bound_ms(nbytes * 3 * nn * nn, float(nn) ** 3,
                               dpx_rate)}
        del ref
    emit({"phase": "apsp", "n": nn, "form": ops.apsp_form(nn),
          "seconds": apsp_s["apsp"], "f32_seconds": apsp_s["apsp_f32"],
          "host_bfs_seconds": bfs_s, "diameter": int(dists["apsp"].max()),
          "squaring": squaring, "equal_to_bfs": True,
          "launches": launches["apsp"], "f32_launches": launches["apsp_f32"]})
    del dfull, hfull, dists, want
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
    del ps, ps_new, full, prev, warm, cold
    torch.cuda.empty_cache()

    # ---- 4''. the §5 routing paths ----------------------------------------- #
    run = PathRun(dev, launches)
    out = build_batch_phase(top, run)
    # the probe with the build pipeline on (one batch build) and off
    # (sequential lazy builds), in turns: on, off, off, on; each must give
    # the probe's verdict and alphas
    probe_turns = {"on": [], "off": []}
    prev_flag = set_build_pipeline(True)
    try:
        for tag in ("on", "off", "off", "on"):
            set_build_pipeline(tag == "on")
            clear_routing_cache()
            path = "probe_sequential" if tag == "off" else "probe_batched"
            got, secs = run(path, lambda: capacity.probe_full_capacity(
                top, n_matrices=3, k=8, iters=500, method="auto",
                device=dev))
            check(got.verdict == probe.verdict
                  and [x.alpha for x in got.mw_results]
                  == [x.alpha for x in res],
                  f"the probe with the build pipeline {tag} differs from "
                  "the probe phase's")
            probe_turns[tag].append(secs)
    finally:
        set_build_pipeline(prev_flag)
    out.update({"probe_seconds_pipeline_on": probe_turns["on"],
                "probe_seconds_pipeline_off": probe_turns["off"],
                "probe_verdict": probe.verdict,
                "probe_sequential_launches": launches["probe_sequential"]})
    emit(out)
    emit(ecmp_phase(run))
    emit(mptcp_phase(top, run))
    torch.cuda.empty_cache()
    out = sim_phase(run)
    emit(out)
    lt = out["loads_ms_per_call"]
    results["fan_in_loads"] = {
        "max_abs_err": 0.0, "ms": lt["fan_in"], "timer": "events",
        "device_ms": lt["fan_in_device"], "plain_ms": lt["plain"],
        "bound_ms": lt["bound_ms"], "bound_by": "bytes",
        "library_ms": lt["library_sparse_csr"], "shape": lt["shape"]}
    torch.cuda.empty_cache()

    # ---- 5. the bisection -------------------------------------------------- #
    # the sequential search (~16 probes) runs at k=24 while it fits what is
    # left of the budget; the wave pair after it (~2 x 20 probes' builds)
    # drops to k=16 first when the budget is short
    k_bis, why_bis = bisection_k(time.perf_counter() - t_start, 16, probe_s)
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
          "k6_servers_cpu": small_cpu, "k_reason": why_bis})
    torch.cuda.empty_cache()
    k_wave, why_wave = bisection_k(time.perf_counter() - t_start, 40, probe_s)
    if k_wave == k_bis:
        best_wave = best
    else:
        # the wave pair's own sequential count at its smaller equipment
        eq_w = fattree_equipment(k_wave)
        best_wave = capacity.max_servers_at_full_capacity(
            eq_w["switches"], eq_w["ports_per_switch"],
            lo=eq_w["servers"] // 2, hi=2 * eq_w["servers"], seeds=(0,),
            method="mw", device=dev)
    emit({**pipeline_bisection(PathRun(dev, launches), k_wave, best_wave),
          "sequential_servers": best_wave, "k_reason": why_wave})
    torch.cuda.empty_cache()

    # ---- 5'. live topology events and the other topology families -------- #
    run = PathRun(dev, launches)
    emit(events_phase(run, n_seeds=EVENTS_SEEDS))
    torch.cuda.empty_cache()
    emit(families_phase(run))
    torch.cuda.empty_cache()

    # the mesh phase's dry-run cells, without and with int8 error feedback
    # (one CPU core each, about three minutes), run from here on; the
    # background checks are stopped when the script exits, whatever the exit
    bg = mesh_background(ROOT / "build" / "mesh_phase",
                         ("dryrun", "dryrun_int8"))
    atexit.register(mesh_stop, bg)

    # ---- 5''. the fabric layer and the obs CLI ---------------------------- #
    out = fabric_phase(PathRun(dev, launches))
    check(out["seconds"] < FABRIC_BUDGET_S,
          f"the fabric phase took {out['seconds']:.1f} s, over its "
          f"{FABRIC_BUDGET_S:.0f} s budget")
    emit(out)
    torch.cuda.empty_cache()
    from repro_torch.obs.__main__ import main as obs_main

    t0 = time.perf_counter()
    rc = obs_main(["smoke", "--device", "cuda"])
    check(rc == 0, f"python -m repro_torch.obs smoke --device cuda: exit {rc}")
    emit({"phase": "obs", "command": "python -m repro_torch.obs smoke "
          "--device cuda", "exit": rc,
          "seconds": time.perf_counter() - t0})

    # the mesh phase's four-rank gloo check runs beside the serve and train
    # phases (the dry-run cell started before the fabric phase)
    mesh_background(ROOT / "build" / "mesh_phase", ("gloo",), bg)

    # ---- 5'''. the model stack's serving path ----------------------------- #
    out = serve_phase(dev)
    check(out["seconds"] < SERVE_BUDGET_S,
          f"the serve phase took {out['seconds']:.1f} s, over its "
          f"{SERVE_BUDGET_S:.0f} s budget")
    check(not any(out["kernel_launches"].values()),
          f"the serving path launched kernels {out['kernel_launches']}")
    emit(out)
    torch.cuda.empty_cache()

    # ---- 5''''. the model stack's training path --------------------------- #
    out = train_phase(dev, ROOT / "build" / "train_phase")
    check(out["seconds"] < TRAIN_BUDGET_S,
          f"the train phase took {out['seconds']:.1f} s, over its "
          f"{TRAIN_BUDGET_S:.0f} s budget")
    steps = [out["reduced_launches"]] + [f["step_launches"]
                                         for f in out["full"].values()]
    check(not any(n for c in steps for n in c.values()),
          f"the train steps launched kernels {steps}")
    launches["train"] = {k: sum(f["main_launches"][k]
                                for f in out["full"].values())
                         for k in steps[0]}
    emit(out)

    # ---- 5'''''. the model stack's mesh half ---------------------------- #
    out = mesh_phase(dev, bg)
    check(out["seconds"] < MESH_BUDGET_S,
          f"the mesh phase took {out['seconds']:.1f} s, over its "
          f"{MESH_BUDGET_S:.0f} s budget")
    emit(out)
    torch.cuda.empty_cache()

    # ---- 5. the dispatch-level audit and the examples ---------------- #
    t_ir = time.perf_counter()
    out, _ = PathRun(dev, launches)("ir", lambda: ir_phase(dev))
    emit(out)
    out, _ = PathRun(dev, launches)(
        "examples", lambda: examples_phase(dev, ROOT / "build" /
                                           "examples_phase"))
    emit(out)
    ir_examples_s = time.perf_counter() - t_ir
    torch.cuda.empty_cache()

    # ---- 6. kernels -------------------------------------------------------- #
    replaces = {
        "congestion": "src/repro/kernels/congestion.py:78",
        "congestion_batch": "src/repro/kernels/congestion.py:99",
        "minplus": "src/repro/kernels/minplus.py:61",
        "minplus_hops": "src/repro/kernels/minplus.py:61",
        "admission": "src/repro/kernels/admission.py:69",
        "matmul": "src/repro/kernels/power.py:50",
        "fan_in_loads": "none: the loads-only calls of congestion.py:99",
    }
    sources = {
        "congestion": "src/repro_torch/kernels/csrc/congestion.cu",
        "congestion_batch": "src/repro_torch/kernels/csrc/congestion.cu",
        "minplus": "src/repro_torch/kernels/csrc/minplus.cu",
        "minplus_hops": "src/repro_torch/kernels/csrc/minplus.cu",
        "admission": "src/repro_torch/kernels/csrc/admission.cu",
        "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
        "fan_in_loads": "src/repro_torch/kernels/csrc/fanin.cu",
    }
    # the path that must launch each kernel; the probe and the bisection
    # solve batched only, the expansion path single instances; every path
    # that runs APSP launches the min-plus form the driver picks for its
    # number of switches
    def apsp_kernel(n_nodes: int) -> str:
        return {"hops": "minplus_hops", "f32": "minplus"}[
            ops.apsp_form(n_nodes)]

    expected = {
        "apsp": (apsp_kernel(nn),),
        "apsp_f32": ("minplus",),
        "spectral": ("matmul",),
        "probe": ("congestion_batch", apsp_kernel(n_sw), "admission"),
        "alpha_of": ("congestion", apsp_kernel(n_sw), "admission"),
        "expansion": ("congestion", apsp_kernel(cur.n_switches), "admission",
                      "matmul"),
        "bisection": ("congestion_batch", apsp_kernel(eq_b["switches"]),
                      "admission"),
        "build_batch": (apsp_kernel(n_sw), "admission"),
        "probe_sequential": ("congestion_batch", apsp_kernel(n_sw),
                             "admission"),
        "probe_batched": ("congestion_batch", apsp_kernel(n_sw),
                          "admission"),
        "ecmp": (apsp_kernel(245), "admission"),
        "mptcp": ("congestion", apsp_kernel(n_sw), "admission"),
        "sim": ("fan_in_loads", apsp_kernel(512), "admission"),
        "events": ("fan_in_loads", apsp_kernel(512), "admission"),
        "families": ("congestion", apsp_kernel(484), "admission"),
        "fabric": (apsp_kernel(FABRIC_CHAIN_PODS), "admission"),
        "ir": tuple(replaces),
        "examples": ("congestion", apsp_kernel(80), "admission"),
        "bisection_wave_on": ("congestion_batch",
                              apsp_kernel(fattree_equipment(k_wave)[
                                  "switches"]), "admission"),
        "bisection_wave_off": ("congestion_batch",
                               apsp_kernel(fattree_equipment(k_wave)[
                                   "switches"]), "admission"),
    }
    for path, names in expected.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} was not launched by the {path} path")
    # the simulator's loads-only products all take the fan-in kernel
    for path in ("sim", "events"):
        check(launches[path]["congestion_batch"] == 0,
              f"the {path} path launched the dense congestion kernel")
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
                     "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("fp32_bound_ms", "dpx_bound_ms",
                                          "device_ms") if k in r}})
    emit({"phase": "time", "seconds": time.perf_counter() - t_start,
          "aim_s": TIME_BUDGET_S, "ir_examples_seconds": ir_examples_s,
          "ir_examples_aim_s": IR_EXAMPLES_BUDGET_S})
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
    if sys.argv[1:2] == ["--gloo-check"]:
        gloo_check(sys.argv[2])
    else:
        main()
