"""Fault-tolerant training loop: checkpoint/restart, NaN handling, straggler
mitigation.

The port of ``repro/runtime/fault.py``, unchanged but for the JAX import
it never used.  The loop wraps an arbitrary ``step_fn(state, batch) ->
(state, metrics)`` with:

* periodic async checkpoints (``CheckpointManager``);
* retry-with-restore on exceptions (simulating preemption / device loss —
  tests inject failures via the ``chaos`` hook);
* NaN/Inf loss policy: ``skip`` (drop the batch, keep momentum) or
  ``restore`` (roll back to the last checkpoint);
* straggler tracking: per-step wall times feed an EWMA; hosts slower than
  ``threshold`` x median are reported to the ``on_straggler`` callback, whose
  production implementation evicts the host and triggers an elastic re-mesh
  (``runtime.elastic`` + ``fabric.FabricModel.remove`` — the paper's §4.3
  story: the degraded fabric is just a smaller random graph).

The loop is deliberately framework-free: state is any pytree, and the data
iterator must be step-addressable for deterministic restart (see
``data.pipeline``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..checkpoint.manager import CheckpointManager

__all__ = ["FaultConfig", "StragglerTracker", "ResilientLoop"]


@dataclasses.dataclass
class FaultConfig:
    checkpoint_every: int = 50
    max_retries: int = 3
    nan_policy: str = "skip"  # skip | restore
    straggler_threshold: float = 2.0  # x median step time
    straggler_window: int = 20


class StragglerTracker:
    """EWMA step-time tracker; flags hosts slower than threshold x median."""

    def __init__(self, n_hosts: int, threshold: float = 2.0, alpha: float = 0.2):
        self.ewma = np.zeros(n_hosts)
        self.seen = np.zeros(n_hosts, dtype=bool)
        self.threshold = threshold
        self.alpha = alpha

    def update(self, per_host_times: np.ndarray) -> list[int]:
        t = np.asarray(per_host_times, dtype=float)
        self.ewma = np.where(
            self.seen, (1 - self.alpha) * self.ewma + self.alpha * t, t
        )
        self.seen[:] = True
        med = np.median(self.ewma)
        if med <= 0:
            return []
        return [int(i) for i in np.flatnonzero(self.ewma > self.threshold * med)]


@dataclasses.dataclass
class LoopReport:
    steps_done: int
    restores: int
    skipped_nan: int
    stragglers_flagged: list
    losses: list


class ResilientLoop:
    def __init__(
        self,
        step_fn: Callable,
        state,
        ckpt: CheckpointManager,
        batch_at: Callable[[int], dict],
        cfg: FaultConfig = FaultConfig(),
        chaos: Callable[[int], None] | None = None,
        host_times: Callable[[int], np.ndarray] | None = None,
        on_straggler: Callable[[list[int]], None] | None = None,
        loss_key: str = "loss",
    ):
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt
        self.batch_at = batch_at
        self.cfg = cfg
        self.chaos = chaos
        self.host_times = host_times
        self.on_straggler = on_straggler
        self.loss_key = loss_key
        self.tracker = None

    def _restore(self, step: int) -> int:
        tree, extra = self.ckpt.restore_latest(target=self.state)
        if tree is None:
            return 0  # no checkpoint yet: restart from scratch
        self.state = tree
        return int(extra.get("step", step))

    def run(self, n_steps: int, start_step: int = 0) -> LoopReport:
        step = start_step
        restores = skipped = 0
        flagged: list = []
        losses: list = []
        retries = 0
        while step < n_steps:
            batch = self.batch_at(step)
            try:
                if self.chaos is not None:
                    self.chaos(step)
                t0 = time.perf_counter()
                new_state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics[self.loss_key])
                dt = time.perf_counter() - t0
            except Exception:
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                self.ckpt.wait()
                step = self._restore(step)
                restores += 1
                continue
            retries = 0
            if not np.isfinite(loss):
                if self.cfg.nan_policy == "skip":
                    skipped += 1
                    step += 1  # drop this batch, keep the old state
                    continue
                self.ckpt.wait()
                step = self._restore(step)
                restores += 1
                continue
            self.state = new_state
            losses.append(loss)
            # straggler accounting (per-host times injected in tests; on a
            # real pod these come from the coordinator's step barrier)
            if self.host_times is not None:
                times = self.host_times(step)
                if self.tracker is None:
                    self.tracker = StragglerTracker(
                        len(times), self.cfg.straggler_threshold
                    )
                slow = self.tracker.update(times)
                if slow:
                    flagged.append((step, slow))
                    if self.on_straggler:
                        self.on_straggler(slow)
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return LoopReport(step - start_step, restores, skipped, flagged, losses)
