"""Deterministic synthetic LM data pipeline (numpy; the port's own copy of
the reference's ``data/pipeline.py``, batch for batch the same).

Produces per-host shards of a structured token stream (Zipf-distributed
vocabulary with Markov bigram structure so the loss actually decreases),
with background prefetch.  Deterministic in (seed, step, host) — a restarted
job resumes the exact stream (fault-tolerance requirement: data must be
replayable from the checkpointed step).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    embed_dim: int = 0        # >0: emit "embeds" instead of tokens (stub
                              # frontends per the assignment)


class SyntheticLM:
    """Zipf marginals + deterministic bigram mixing."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random permutation as the bigram successor map
        self._succ = rng.permutation(v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index))
        shape = (self.local_batch, cfg.seq_len + 1)
        toks = rng.choice(cfg.vocab_size, size=shape, p=self._probs)
        # mix in bigram structure: with p=0.5 the next token is succ[prev]
        follow = rng.random(shape[:1] + (shape[1] - 1,)) < 0.5
        for t in range(1, shape[1]):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self._succ[toks[:, t - 1]], toks[:, t])
        out = {"labels": toks[:, 1:].astype(np.int32)}
        if cfg.embed_dim:
            emb_rng = np.random.default_rng((cfg.seed + 7, step,
                                             cfg.host_index))
            out["embeds"] = (emb_rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.embed_dim))
                .astype(np.float32) * 0.02)
        else:
            out["tokens"] = toks[:, :-1].astype(np.int32)
        return out

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of the host data stream."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
