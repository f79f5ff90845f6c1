"""Tiny cells of each kind for the CPU tests: the benchmark's own
configurations and traffic mixes with their scale cut so that a whole run
takes a second or two on the host."""

from __future__ import annotations

import json
import time

import torch

from portbench import harness

CONFIGS = harness.HERE / "configs"
TRAFFIC = harness.HERE / "traffic"


def _load(folder, name: str) -> dict:
    return json.loads((folder / f"{name}.json").read_text())


def cell(kind: str, **traffic) -> harness.Cell:
    """A tiny cell of ``kind`` (``probe``, ``expand`` or ``sim``)."""
    if kind == "sim":
        config = _load(CONFIGS, "rrg512x8")
        config.update(switches=64, instances=2, max_flows=256, max_arrivals=8)
        tr = _load(TRAFFIC, "sim_ksp")
        tr.update(steps=40, rate=4.0, size=12.0)
    else:
        config = _load(CONFIGS, "jf720-k24")
        config.update(switches=40, ports=10, base_servers=160, net_degree=6)
        tr = _load(TRAFFIC, kind)
        if kind == "probe":
            tr.update(servers={"first": 100, "last": 140, "step": 20},
                      iters=200)
        else:
            tr.update(add_switches=4, lambda2_iters=100, cold_iters=100,
                      warm_iters=60)
    tr.update(traffic)
    return harness.Cell(f"tiny.{kind}", 1, config, tr, tr["kind"], [], [])


def run(c: harness.Cell, seed: int = 2**31 + 77, seconds: float = 0.2,
        **kw) -> dict:
    """One CPU run of ``c`` through the harness."""
    return harness.execute(c, seed, seconds, False, torch.device("cpu"),
                           time.perf_counter(), **kw)


def mw_everywhere(monkeypatch) -> None:
    """Tiny probes sit under the program's LP cutoff: send them to MW, as
    every probe of the full-size cell is."""
    from repro_torch import capacity

    monkeypatch.setattr(capacity, "MW_MIN_PATHS", 0)
