"""The congestion roofline counts the routing table's sparse work, so a
change of backend changes the kernel time and never the count."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline
from portbench.kinds import probe


def _records(backend):
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
    res = mw_concurrent_flow_batch(systems, iters=40, backend=backend,
                                   device="cpu")
    return [{"tables": [probe.tables(ps) for ps in systems],
             "results": [{"iters": r.iters, "alpha": r.alpha} for r in res]}]


def test_count_is_the_same_for_dense_and_gather():
    dense = probe.congestion_work(_records("dense"))
    gather = probe.congestion_work(_records("gather"))
    assert dense.bytes == gather.bytes > 0
    assert dense.flops == gather.flops > 0


def test_count_of_one_call():
    # 10 path-hop entries over 4 paths and 6 slots
    b, f = roofline.call_work(10, 4, 6)
    assert (b, f) == (4 * 10 + 4 * 4 + 4 * 6 + 4 * 6 + 4 * 4, 20)
    b, f = roofline.call_work(10, 4, 6, fused=False)
    assert (b, f) == (4 * 10 + 4 * 4 + 4 * 6, 10)
    w = roofline.Work()
    w.add((3.35e12, 0.0))
    assert roofline.bound_seconds(w) == pytest.approx(1.0)
    assert roofline.share_percent(w, 2.0) == pytest.approx(50.0)
    assert roofline.share_percent(w, 0.0) is None
    assert roofline.share_percent(roofline.Work(), 1.0) is None


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    from portbench.reference.mw import to_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1 / 3, float("inf")])
    y = to_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10 and y[4] == float("inf")
    assert y[1] in (1.0, 1.0 + 2**-10)
    assert abs(float(y[3]) - 1 / 3) <= 2**-12
    bits = y[:4].view(torch.int32) & 0x1FFF
    assert np.all(bits.numpy() == 0)
