"""Deterministic synthetic tokenized data pipeline (a copy of the
reference's ``data/pipeline.py``: the same numpy draws, so batch ``i`` of
shard ``s`` is byte-identical to the reference's for the same seed).

Production shape without external datasets: an infinite, seeded, *sharded*
token stream (Zipfian unigrams over n-gram templates so models actually have
structure to learn), packed to fixed sequence length, with background
prefetch and an exactly-resumable cursor (saved in checkpoints — restart
resumes the stream bit-exactly, including after elastic re-sharding).
Batches are numpy int32; the training loop moves them to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_templates: int = 64
    template_len: int = 16
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Template n-gram language: templates of token spans stitched by a
    Zipfian background distribution — compressible, non-trivial structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.templates = rng.integers(
            2, cfg.vocab, (cfg.n_templates, cfg.template_len), dtype=np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.zipf_p = p / p.sum()

    def sample_doc(self, rng: np.random.Generator) -> np.ndarray:
        parts = [np.array([1], np.int32)]  # BOS
        length = 0
        target = int(rng.integers(self.cfg.seq_len // 2, self.cfg.seq_len * 2))
        while length < target:
            if rng.random() < 0.6:
                t = self.templates[rng.integers(0, self.cfg.n_templates)]
                parts.append(t)
                length += len(t)
            else:
                n = int(rng.integers(4, 17))
                parts.append(rng.choice(self.cfg.vocab, n, p=self.zipf_p).astype(np.int32))
                length += n
        return np.concatenate(parts)[:target]


@dataclasses.dataclass
class LoaderState:
    """Exactly-resumable cursor: (shard id, step count) seeds the PRNG."""

    step: int = 0

    def as_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        return cls(step=int(d["step"]))


class ShardedLoader:
    """Packs documents into (local_batch, seq_len+1) token blocks per host
    shard. Determinism: batch ``i`` of shard ``s`` depends only on (seed, s,
    i), so elastic restarts with a different shard count can replay any
    global batch exactly by re-mapping shard ids."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 state: LoaderState | None = None):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.corpus = SyntheticCorpus(cfg)
        self.state = state or LoaderState()

    def _batch_at(self, step: int) -> dict:
        rows = []
        for b in range(self.local_batch):
            rng = np.random.default_rng(
                (self.cfg.seed, self.shard * self.local_batch + b, step))
            buf = np.empty(0, np.int32)
            while len(buf) < self.cfg.seq_len + 1:
                buf = np.concatenate([buf, self.corpus.sample_doc(rng)])
            rows.append(buf[: self.cfg.seq_len + 1])
        block = np.stack(rows)
        return {"tokens": block[:, :-1], "labels": block[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            batch = self._batch_at(self.state.step)
            self.state.step += 1
            yield batch


class Prefetcher:
    """Background-thread prefetch (depth-N) over any batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            yield item
