"""The port's meshes (``launch.mesh``) over fake and one-rank process groups.

``make_production_mesh`` and ``make_local_mesh`` are checked for shape and
axis names over a fake group (``torch.testing``'s ``FakeStore``: rank 0 of
a world of 256, 512 or 6, no communication); too small a world raises and
names the world it needs, as the reference's ``jax.make_mesh`` fails there;
with no group a one-rank gloo group is made on an in-memory store.
``make_fabric_aware_mesh`` lays out the ranks as the reference lays out its
devices (``np.stack`` of the pods' blocks in ring order) for the same
fabric seed, read from a JAX subprocess with 32 forced host devices.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.fabric import make_fabric
from repro_torch.launch.mesh import (
    make_fabric_aware_mesh,
    make_local_mesh,
    make_production_mesh,
    world_size,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fake_world(request):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def _layout(mesh):
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names))


@pytest.mark.parametrize("fake_world", [256, 512], indirect=True)
def test_production_mesh_shapes(fake_world):
    mesh = make_production_mesh(device="cpu")
    assert _layout(mesh) == ((16, 16), ("data", "model"))
    assert mesh.mesh.flatten().tolist() == list(range(256))
    if fake_world == 512:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert _layout(mesh) == ((2, 16, 16), ("pod", "data", "model"))
        assert mesh.mesh.flatten().tolist() == list(range(512))
    else:
        with pytest.raises(ValueError, match="world of 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("fake_world", [6], indirect=True)
def test_too_small_a_world_raises(fake_world):
    with pytest.raises(ValueError, match="world of 256 ranks; the process "
                                         "group has 6"):
        make_production_mesh(device="cpu")


@pytest.mark.parametrize("fake_world,mp,shape", [
    (6, None, (6, 1)), (6, 4, (3, 2)), (6, 3, (2, 3)),
    (256, None, (256, 1)), (256, 16, (16, 16)), (256, 3, (256, 1)),
    (512, 16, (32, 16)),
], indirect=["fake_world"])
def test_local_mesh_halves_the_model_axis_until_it_divides(fake_world, mp,
                                                           shape):
    mesh = make_local_mesh(mp, device="cpu")
    assert _layout(mesh) == (shape, ("data", "model"))


def test_no_group_makes_a_one_rank_group():
    assert not dist.is_initialized()
    try:
        assert world_size("cpu") == 1
        assert dist.get_backend() == "gloo"
        mesh = make_local_mesh(16, device="cpu")
        assert _layout(mesh) == ((1, 1), ("data", "model"))
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()


def test_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh()
    assert not dist.is_initialized()


_REFERENCE = r'''
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
import numpy as np
from repro.fabric import make_fabric
from repro.launch.mesh import make_fabric_aware_mesh
mesh, order = make_fabric_aware_mesh(
    make_fabric("jellyfish", n_pods=8, seed=3), 8, (2, 2))
ids = np.vectorize(lambda d: d.id)(mesh.devices).tolist()
print(json.dumps({"order": order, "ids": ids,
                  "names": list(mesh.axis_names)}))
'''


@pytest.mark.parametrize("fake_world", [32], indirect=True)
def test_fabric_aware_mesh_equals_reference_layout(fake_world):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    fabric = make_fabric("jellyfish", n_pods=8, seed=3, device="cpu")
    mesh, order = make_fabric_aware_mesh(fabric, 8, (2, 2), device="cpu")
    assert order == ref["order"]
    assert sorted(order) == list(range(8)) and order != list(range(8))
    assert mesh.mesh.tolist() == ref["ids"]
    assert list(mesh.mesh_dim_names) == ref["names"]
    with pytest.raises(ValueError, match="world of 64 ranks"):
        make_fabric_aware_mesh(fabric, 8, (2, 4), device="cpu")
