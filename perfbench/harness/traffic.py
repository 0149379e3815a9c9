"""The general traffic generators.  A mix under ``traffic/`` is a JSON file
of parameters whose ``kind`` names one of these; the seed of a run draws
everything else.

``closed_loop``: ``clients`` clients, each sending its next request as
soon as its last is answered, with no think time; so every batch is one
request of each client.  A request's prompt length is uniform over
``prompt_len`` ([low, high]), drawn from a stream fixed by the request's
place in the loop, so every seed serves the same lengths and the seed
changes no work; its ids are uniform over the vocabulary, drawn from the
seed; each asks for ``new_tokens`` greedy tokens.  The warm-up batch is
every client at the longest length.

``synthetic_lm``: the benchmark's own copy of the port's ``SyntheticLM``
stream (Zipf marginals with exponent ``zipf``, each next token the
previous one's fixed successor with probability ``follow``): step ``i``
draws ``batch`` rows of ``seq_len`` tokens and their next-token labels,
all rows of all steps different.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Prompt:
    uid: int
    tokens: np.ndarray
    new_tokens: int


class ClosedLoop:
    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab_size, seed

    def _batch(self, index: int, lens) -> list[Prompt]:
        rng = np.random.default_rng((self.seed, index + 1))
        return [Prompt(uid=(index + 1) * self.mix["clients"] + c,
                       tokens=rng.integers(0, self.vocab, int(n)),
                       new_tokens=self.mix["new_tokens"])
                for c, n in enumerate(lens)]

    def batch(self, index: int) -> list[Prompt]:
        """The ``index``-th batch (from 0): one request of each client."""
        lo, hi = self.mix["prompt_len"]
        lens = np.random.default_rng(index).integers(
            lo, hi + 1, self.mix["clients"])
        return self._batch(index, lens)

    def warmup(self) -> list[Prompt]:
        """Every client at the longest prompt: the window's largest shapes."""
        return self._batch(-1, [self.mix["prompt_len"][1]]
                           * self.mix["clients"])


class SyntheticLM:
    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab_size, seed
        rng = np.random.default_rng(seed)
        self._succ = rng.permutation(vocab_size)
        p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** mix["zipf"]
        self._probs = p / p.sum()

    def batch(self, step: int, rows: slice = slice(None)) -> dict:
        """Step ``step``'s tokens and labels (int64, (batch, seq_len))."""
        m = self.mix
        rng = np.random.default_rng((self.seed, step, 0))
        shape = (m["batch"], m["seq_len"] + 1)
        toks = rng.choice(self.vocab, size=shape, p=self._probs)
        follow = rng.random((shape[0], shape[1] - 1)) < m["follow"]
        for t in range(1, shape[1]):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self._succ[toks[:, t - 1]], toks[:, t])
        return {"tokens": toks[rows, :-1].astype(np.int64),
                "labels": toks[rows, 1:].astype(np.int64)}


KINDS = {"closed_loop": ClosedLoop, "synthetic_lm": SyntheticLM}


def generator(mix: dict, vocab_size: int, seed: int):
    return KINDS[mix["kind"]](mix, vocab_size, seed)
