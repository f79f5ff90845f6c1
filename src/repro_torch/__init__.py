"""PyTorch + CUDA port of the Jellyfish reproduction (``repro``).

A second package beside the JAX reference, mirroring its layout module by
module: ``env``, ``obs``, ``analysis.contracts``, ``core`` (topologies,
traffic, routing with the cross-instance batch build, the build pipeline,
flow, fluid MPTCP, bisection), ``sim`` (the flow-level simulator: ECMP,
waterfilling, workloads, telemetry), ``kernels`` (hand-written CUDA
kernels for Hopper, each with a plain torch version) and ``capacity``
(the Fig 1c servers-at-full-capacity search).  It imports torch, numpy and scipy, never
JAX and nothing of ``repro``.  Entry points take ``device=`` and default to
``"cuda"``.
"""
