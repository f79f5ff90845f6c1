"""Checkpointing: async saves, the reference's on-disk format.

The port of ``repro/checkpoint/manager.py``.  Format: one ``step_<N>/``
directory per checkpoint holding ``manifest.json`` (each array's shape and
dtype under its flat name, plus ``extra``) and ``arrays.msgpack.zst`` (zstd,
when the ``zstandard`` module is there) or ``arrays.msgpack.zlib``: a
MessagePack map of flat name -> raw bytes (``codec``, the port's own
encoder of that map).  The directory is written as ``step_<N>.tmp`` and
renamed into place; ``keep`` bounds retention.  A tree saved by either
package loads in the other.

Trees are nested dicts (keys sorted, as JAX flattens them), lists, tuples
and dataclasses (``optim.OptState``: by field name) over tensors, numpy
arrays and scalars; flat names join the keys with ``/``.  A tensor is
copied to the host when it is saved (the port updates its tensors in
place, so the copy is what keeps the checkpoint consistent); bfloat16 is
stored as its raw 16 bits under the dtype name ``bfloat16``, as the
reference's ``ml_dtypes`` arrays are.  ``load_pytree(target=...)`` puts
each array on the target leaf's device and dtype.

Under a mesh a leaf may be a DTensor: saving gathers its full value (every
rank takes part; rank 0 of the process group writes), so the format stays
the reference's and either package reads it.  ``load_pytree(...,
shardings=)`` distributes each array onto its ``runtime.sharding.Sharding``
(a tree matching ``target``, None where a leaf stays plain); a target leaf
that is a DTensor and has no sharding given keeps its own placements.  A
checkpoint saved on one mesh thus restores onto another, or into an
unsharded model (``runtime.elastic.replan``'s reshard).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import shutil
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from .codec import packb, unpackb

try:  # optional: zstd when the wheel is available, zlib fallback otherwise
    import zstandard
except ModuleNotFoundError:  # pragma: no cover - depends on the image
    zstandard = None

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

# blob name encodes the codec so readers never guess
_BLOB_ZSTD = "arrays.msgpack.zst"
_BLOB_ZLIB = "arrays.msgpack.zlib"
_BF16 = "bfloat16"


def _compress(raw: bytes) -> tuple[str, bytes]:
    if zstandard is not None:
        return _BLOB_ZSTD, zstandard.ZstdCompressor(level=3).compress(raw)
    return _BLOB_ZLIB, zlib.compress(raw, level=3)


def _decompress(directory: pathlib.Path) -> bytes:
    zst, zlb = directory / _BLOB_ZSTD, directory / _BLOB_ZLIB
    if zst.exists():
        if zstandard is None:
            raise ModuleNotFoundError(
                f"checkpoint {zst} is zstd-compressed but the 'zstandard' "
                "module is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(zst.read_bytes())
    return zlib.decompress(zlb.read_bytes())


def _children(node):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """{flat name: leaf}; None is an empty subtree, as in JAX."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_host(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, a host array holding the leaf's bytes); a tensor is
    copied, so later in-place updates do not reach the checkpoint, and a
    DTensor's full value is gathered first."""
    if isinstance(leaf, torch.Tensor):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        a = t.numpy()
        return str(a.dtype), a
    a = np.asarray(leaf)
    return str(a.dtype), a


def _host_arrays(tree) -> dict:
    return {name: _to_host(leaf) for name, leaf in _flatten(tree).items()}


def _write(arrays: dict, directory: pathlib.Path, extra: dict | None):
    tmp = directory.with_name(directory.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {
        "arrays": {
            k: {"shape": list(a.shape), "dtype": dt}
            for k, (dt, a) in arrays.items()
        },
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    raw = packb({k: a.tobytes() for k, (_, a) in arrays.items()})
    blob_name, blob = _compress(raw)
    (tmp / blob_name).write_bytes(blob)
    if directory.exists():
        shutil.rmtree(directory)
    tmp.rename(directory)  # atomic publish
    return directory


def _writer() -> bool:
    """Whether this process writes: rank 0 of the process group, if any."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _wait_for_writer() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_pytree(tree, directory: str | pathlib.Path, extra: dict | None = None):
    """Write ``tree``; every rank of a process group calls it (DTensors are
    gathered), rank 0 writes and the others wait for it."""
    arrays = _host_arrays(tree)
    if _writer():
        _write(arrays, pathlib.Path(directory), extra)
    _wait_for_writer()
    return pathlib.Path(directory)


def _array(raw: bytes, meta: dict):
    """A stored array: numpy, or a CPU bfloat16 tensor (numpy has none)."""
    shape = tuple(meta["shape"])
    if meta["dtype"] == _BF16:
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(shape)


def _like(arr, leaf, sharding=None):
    """``arr`` as ``leaf`` holds it: a tensor on its device and dtype (a
    parameter stays a parameter), distributed by ``sharding`` or, for a
    DTensor leaf, by the leaf's own placements; else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr, copy=True))
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if sharding is not None:
            t = sharding.distribute(t)
        elif isinstance(leaf, DTensor):
            t = distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                  src_data_rank=None)
        if isinstance(leaf, torch.nn.Parameter):
            return torch.nn.Parameter(t, requires_grad=leaf.requires_grad)
        return t
    return arr


def _sub(shardings, key):
    """The shardings subtree under ``key`` (None when there is none)."""
    if shardings is None:
        return None
    if isinstance(shardings, dict):
        return shardings.get(key)
    if isinstance(shardings, (list, tuple)):
        return shardings[key]
    return getattr(shardings, key, None)


def _rebuild(node, arrays: dict, prefix: str = "", shardings=None):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return _like(arrays[prefix], node, shardings)
    new = {k: _rebuild(v, arrays, f"{prefix}/{k}" if prefix else str(k),
                       _sub(shardings, k))
           for k, v in kids}
    if isinstance(node, dict):
        return {k: new[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(new[i] for i in range(len(node)))
    return dataclasses.replace(node, **new)


def load_pytree(directory: str | pathlib.Path, target=None, shardings=None):
    """Load arrays; if ``target`` is given, restore its tree structure with
    each array on the target leaf's device and dtype; if ``shardings`` is
    given (a tree of ``Sharding`` matching ``target``), each array is
    distributed onto its sharding."""
    directory = pathlib.Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    blobs = unpackb(_decompress(directory))
    arrays = {name: _array(blobs[name], meta)
              for name, meta in manifest["arrays"].items()}
    if target is None:
        return arrays, manifest["extra"]
    return _rebuild(target, arrays, shardings=shardings), manifest["extra"]


class CheckpointManager:
    def __init__(self, root, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._pending: list = []

    def dir_for(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.root.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp")
        )

    def save(self, step: int, tree, extra: dict | None = None, blocking=False):
        """Async save (the host copy happens synchronously for
        consistency)."""
        arrays = _host_arrays(tree)
        extra = dict(extra or {}, step=step)

        def job():
            if _writer():
                _write(arrays, self.dir_for(step), extra)
                self._gc()

        fut = self._pool.submit(job)
        self._pending.append(fut)
        if blocking:
            fut.result()
            _wait_for_writer()
        return fut

    def wait(self):
        for f in self._pending:
            f.result()
        self._pending.clear()

    def restore_latest(self, target=None, shardings=None):
        steps = self.steps()
        if not steps:
            return None, None
        return load_pytree(self.dir_for(steps[-1]), target, shardings)

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)
