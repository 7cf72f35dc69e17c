"""Token data pipeline: deterministic, host-sharded, restart-safe — the
port of ``repro.data.pipeline``, numpy as the reference is, and giving
the same tokens for the same seeds.

* **determinism** — batch ``i`` is a pure function of (seed, step, host),
  so a restarted host replays exactly its own stream, with no global
  replay and no coordination;
* **host sharding** — :func:`deterministic_shard` slices the global batch
  by host id; the hosts' slices, concatenated, are the global batch;
* **prefetch** — :class:`HostDataLoader` keeps ``prefetch`` batches ready
  in a background thread.

The corpus is synthetic: a zipfian unigram mixture with per-document
markov structure over topics.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLMDataset:
    """Deterministic synthetic token streams."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.n_states = n_states
        root = np.random.default_rng(seed)
        # a small markov model over "topics", each topic a zipf slice
        self.topic_offsets = root.integers(0, max(vocab - 512, 1),
                                           size=n_states)
        self.trans = root.dirichlet(np.ones(n_states) * 0.2,
                                    size=n_states)

    def sample(self, step: int, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + index)
        state = int(rng.integers(self.n_states))
        toks = np.empty(self.seq_len + 1, np.int32)
        for t in range(self.seq_len + 1):
            if t % 64 == 0:
                state = int(rng.choice(self.n_states,
                                       p=self.trans[state]))
            z = rng.zipf(1.5)
            toks[t] = (self.topic_offsets[state] + z) % self.vocab
        return toks

    def batch(self, step: int, batch_size: int,
              start_index: int = 0) -> Dict[str, np.ndarray]:
        seqs = np.stack([self.sample(step, start_index + i)
                         for i in range(batch_size)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


def deterministic_shard(global_batch: int, host_id: int,
                        n_hosts: int) -> range:
    """Contiguous per-host index range; ∪ hosts = [0, global_batch)."""
    per = global_batch // n_hosts
    rem = global_batch % n_hosts
    start = host_id * per + min(host_id, rem)
    size = per + (1 if host_id < rem else 0)
    return range(start, start + size)


def make_lm_batches(dataset: SyntheticLMDataset, global_batch: int,
                    host_id: int = 0, n_hosts: int = 1,
                    start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """This host's rows of every global batch from ``start_step`` on."""
    idx = deterministic_shard(global_batch, host_id, n_hosts)
    step = start_step
    while True:
        yield dataset.batch(step, len(idx), start_index=idx.start)
        step += 1


class HostDataLoader:
    """Background-thread prefetching wrapper around any batch iterator."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._done:
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._done = True
