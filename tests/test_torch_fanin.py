"""The fan-in loads wrapper (``kernels/fanin.py``) on the CPU: its plain
version against ``core.flow._ordered_fan_in_sum`` bit for bit, its operand
checks, and the backend choice that sends loads-only products to it.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import jellyfish, random_permutation_traffic
from repro_torch.core.flow import (
    PathSystemBatch,
    _columns,
    _empty_path_system,
    _ordered_fan_in_sum,
    make_loads_fn_batch,
)
from repro_torch.core.routing import build_path_system
from repro_torch.kernels import ops
from repro_torch.kernels.fanin import (
    _ir_operands,
    fan_in_loads,
    fan_in_loads_ref,
    fan_in_table,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ordered(table, rates, L):
    """``_ordered_fan_in_sum`` as the MW closures call it: rates repeated
    ``L`` times with a trailing zero, over int64 columns of the (.., S, D)
    table."""
    fr = torch.cat([rates.repeat_interleave(L, dim=1),
                    torch.zeros((rates.shape[0], 1))], dim=1)
    cols = _columns(table.numpy().swapaxes(-1, -2), CPU)
    out = _ordered_fan_in_sum(fr, cols)
    return torch.zeros((rates.shape[0], table.shape[-1])) if out is None \
        else out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape,slots,shared", [
    ((9, 3, 11), (11, 7, 0), False),
    ((40, 4, 33), (33, 1, 20, 33), False),
    ((40, 4, 33), (33, 33), True),
    ((5, 2, 7), (0, 0), False),           # no rows at all: D = 0
    ((300, 4, 517), (517, 0, 400), False),
])
def test_plain_equals_ordered_fan_in_sum(shape, slots, shared):
    table, rates, L, sl = _ir_operands(CPU, shared=shared, shape=shape,
                                       slots=slots, seed=len(slots))
    if shared:
        sl = None
    want = _ordered(table, rates, L)
    got = fan_in_loads(table, rates, L, sl)
    assert got.shape == (len(slots), shape[2])
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(fan_in_loads_ref(table, rates, L, sl)),
                       _bits(want))


def test_signed_zeros_and_zero_rates_follow_the_plain_order():
    """-0.0 rates: a full row (as long as D) sums to -0.0, a shorter one
    adds the pad's +0.0 once and reads +0.0; zero rates are still read."""
    table, rates, L, sl = _ir_operands(CPU, shape=(30, 3, 17),
                                       slots=(17, 17), seed=4)
    rates[0] = -0.0
    rates[1, ::2] = 0.0
    got = fan_in_loads(table, rates, L, sl)
    assert torch.equal(_bits(got), _bits(_ordered(table, rates, L)))
    full = (table[0] < 30 * 3).all(dim=0)
    assert full.any() and not full.all()
    assert torch.equal(_bits(got[0, full]),
                       _bits(torch.full((int(full.sum()),), -0.0)))
    assert torch.equal(_bits(got[0, ~full]), _bits(torch.zeros(
        int((~full).sum()))))


def _small_batch():
    tops = [jellyfish(20 + 4 * s, 6, 4, seed=s) for s in range(2)]
    systems = [build_path_system(t, random_permutation_traffic(t, seed=s),
                                 k=4, device=CPU) for s, t in enumerate(tops)]
    return PathSystemBatch.from_systems(systems + [_empty_path_system()])


def test_loads_closure_goes_through_the_wrapper_on_the_cpu():
    """``make_loads_fn_batch``'s gather closure over a real batch (a filler
    member, slots past each member's extent) equals ``_ordered_fan_in_sum``
    bit for bit and launches nothing on the CPU."""
    batch = _small_batch()
    B, S = batch.n_batch, batch.s_max
    pe = torch.as_tensor(batch.path_edges)
    ext = (batch.n_paths, [ps.n_slots for ps in batch.systems])
    rates = torch.from_numpy(np.random.default_rng(2).random(
        (B, batch.p_max)).astype(np.float32))
    before = kernels.launch_counts()
    got = make_loads_fn_batch(pe, S, "gather", batch.slot_gather,
                              extents=ext)(rates)
    assert kernels.launch_counts() == before
    want = _ordered(fan_in_table(batch.slot_gather, CPU), rates,
                    pe.shape[-1])
    assert torch.equal(_bits(got), _bits(want))
    for i, s in enumerate(ext[1]):
        assert not got[i, s:].any()


def test_fan_in_table_is_the_transposed_int32_table():
    batch = _small_batch()
    tab = fan_in_table(batch.slot_gather, CPU)
    assert tab.dtype == torch.int32 and tab.is_contiguous()
    np.testing.assert_array_equal(tab.numpy(),
                                  batch.slot_gather.swapaxes(-1, -2))


def _bad(case):
    table, rates, L, slots = _ir_operands(CPU)
    if case == "table-int64":
        table = table.to(torch.int64)
    elif case == "table-float":
        table = table.to(torch.float32)
    elif case == "rates-float64":
        rates = rates.to(torch.float64)
    elif case == "table-strided":
        table = table.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "rates-strided":
        rates = rates.t().contiguous().t()
    elif case == "members":
        table = table[:2].contiguous()
    elif case == "rates-rank":
        rates = rates[0]
    elif case == "L":
        L = 0
    elif case == "slots-range":
        slots = np.array([12, 7, 0])
    elif case == "slots-shape":
        slots = np.array([11, 7])
    elif case == "slots-float":
        slots = np.array([11.0, 7.0, 0.0])
    elif case == "table-device":
        table = table.to("meta")
    elif case == "device":
        table, rates = table.to("meta"), rates.to("meta")
    return table, rates, L, slots


@pytest.mark.parametrize("case", [
    "table-int64", "table-float", "rates-float64", "table-strided",
    "rates-strided", "members", "rates-rank", "L", "slots-range",
    "slots-shape", "slots-float", "table-device", "device"])
def test_wrapper_rejects_bad_operands(case):
    with pytest.raises(ValueError):
        fan_in_loads(*_bad(case))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_loads_only_products_resolve_to_gather(device):
    """At the sim cell's shape (8 x 24,576 x 10,240, an 8 GB stack that fits
    the card's dense budget) a loads-only product is ``gather`` on either
    device; the fused choice at the probe's shape is unchanged."""
    sim = (24576, 10240)
    assert ops.preferred_congestion_backend(*sim, n_batch=8, device=device,
                                            loads_only=True) == "gather"
    probe = (40960, 14336)
    fused = ops.preferred_congestion_backend(*probe, n_batch=4, device=device)
    assert fused == {"cuda": "dense", "cpu": "gather"}[device]
    assert ops.preferred_congestion_backend(*sim, n_batch=8,
                                            device="cuda") == "dense"
