"""Host-side data pipelines: deterministic, shardable, prefetching.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, so both
packages draw the same batches from the same seed); the caller moves each
batch to the device.

Two sources plus a generic prefetcher:

* :class:`TokenPipeline` — LM token streams.  Backed by a memmap of token
  ids (or a synthetic deterministic generator when no corpus is mounted).
  Each host reads its own disjoint slice (shard_id / num_shards), so the
  global batch assembles without any cross-host IO.
* :class:`RecsysPipeline` — synthetic clickstream with zipfian item
  popularity and a streaming logQ (sampling-probability) estimator, the
  input to the paper-standard logQ-corrected sampled softmax.
* :class:`Prefetcher` — background thread keeping ``depth`` batches ready.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenPipeline", "RecsysPipeline", "Prefetcher"]


class TokenPipeline:
    def __init__(self, batch: int, seq_len: int, vocab: int,
                 shard_id: int = 0, num_shards: int = 1,
                 memmap_path: str | None = None, seed: int = 0):
        self.batch = batch
        self.seq = seq_len
        self.vocab = vocab
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._mm = None
        if memmap_path:
            self._mm = np.memmap(memmap_path, dtype=np.int32, mode="r")
        self._rng = np.random.default_rng(seed * 1000 + shard_id)
        self._pos = shard_id * batch * seq_len

    def __iter__(self):
        return self

    def __next__(self):
        b, s = self.batch, self.seq
        if self._mm is not None:
            need = b * (s + 1)
            stride = need * self.num_shards
            if self._pos + need >= len(self._mm):
                self._pos = self.shard_id * need
            chunk = np.asarray(self._mm[self._pos:self._pos + need])
            self._pos += stride
            arr = chunk.reshape(b, s + 1)
        else:
            # synthetic: markov-ish stream so loss can actually decrease
            base = self._rng.integers(0, self.vocab, size=(b, 1))
            steps = self._rng.integers(-3, 4, size=(b, s))
            arr = (base + np.cumsum(steps, 1)) % self.vocab
            arr = np.concatenate([base % self.vocab, arr], axis=1)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}


class RecsysPipeline:
    def __init__(self, batch: int, cfg, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0):
        self.batch = batch
        self.cfg = cfg
        self._rng = np.random.default_rng(seed * 1000 + shard_id)
        # zipf over items; logQ estimated from the analytic distribution
        v = cfg.item_vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def __iter__(self):
        return self

    def __next__(self):
        cfg, b = self.cfg, self.batch
        rng = self._rng
        items = rng.choice(cfg.item_vocab, size=b, p=self._p)
        out = {
            "user_ids": rng.integers(
                -1, cfg.user_vocab,
                size=(b, cfg.n_user_fields, cfg.bag_len)
            ).astype(np.int32),
            "user_dense": rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32
            ),
            "item_ids": items.astype(np.int32),
            "item_dense": rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32
            ),
            "item_logq": np.log(self._p[items]).astype(np.float32),
        }
        return out


class Prefetcher:
    """Background-thread prefetch of any iterator (depth-bounded)."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()

        def run():
            try:
                for x in it:
                    self._q.put(x)
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
