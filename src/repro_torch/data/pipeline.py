"""Data pipeline: deterministic synthetic LM stream + memmap token shards,
host-sharded, with background prefetch.

The port's copy of ``repro/data/pipeline.py`` (numpy only), unchanged: the
same Philox stream per (seed, step, host) in the same call order, so the
batches equal the reference's bit for bit.

Determinism contract: batch contents are a pure function of
(seed, step, host_id) — a restarted job resumes bit-identically from the
checkpointed step, and elastic re-sharding (host count change) re-partitions
the same global stream.  That property is what the fault-tolerance tests
assert.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapTokens", "Prefetcher", "make_batches"]


class SyntheticLM:
    """Zipf-ish deterministic token stream (counting-hash PRNG per step)."""

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        assert global_batch % n_hosts == 0, "global batch must split over hosts"
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts

    def batch_at(self, step: int) -> dict:
        # philox-style: independent stream per (seed, step, host)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[step, self.host_id, 0, 0])
        )
        # zipf-ish marginal: heavy head like natural text token stats
        z = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        tokens = (z - 1) % self.vocab
        return {"tokens": tokens.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapTokens:
    """Flat binary token file (uint16/uint32), host-strided sequence packing."""

    def __init__(
        self,
        path: str,
        seq_len: int,
        global_batch: int,
        dtype=np.uint16,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.n_seqs = (len(self.data) - 1) // seq_len

    def batch_at(self, step: int) -> dict:
        out = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            gidx = (step * self.local_batch * self.n_hosts
                    + self.host_id * self.local_batch + i) % self.n_seqs
            s = gidx * self.seq_len
            out[i] = self.data[s : s + self.seq_len + 1]
        return {"tokens": out}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded queue."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()  # unblock the producer if waiting
        except queue.Empty:
            pass


def make_batches(
    vocab: int,
    seq_len: int,
    global_batch: int,
    seed: int = 0,
    host_id: int = 0,
    n_hosts: int = 1,
    prefetch: int = 2,
    start_step: int = 0,
):
    """Standard entry point: prefetched deterministic stream from a step."""
    src = SyntheticLM(vocab, seq_len, global_batch, seed, host_id, n_hosts)

    def gen():
        step = start_step
        while True:
            yield src.batch_at(step)
            step += 1

    return Prefetcher(gen(), depth=prefetch)
