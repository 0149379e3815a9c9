"""A serving cell: the port's ``ServingEngine.generate`` driven by a closed
loop of clients, and its answers held against the plain reference."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from ..reference import decoder
from ..reference.common import Arch
from ..reference.numerics import Numerics, set_strict_float32
from . import program, traffic, weights


@dataclasses.dataclass
class Batch:
    prompts: list           # traffic.Prompt
    completions: list       # the engine's Completion, in the same order
    submitted: float        # host clock when its requests were sent
    ended: float            # host clock when their answers were back

    @property
    def padded_len(self) -> int:
        return max(len(p.tokens) for p in self.prompts)


class ServeCell:
    kind = "serve"

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 check: dict):
        """``check``: the cell's check sizes (``requests``, how many of the
        window's requests the reference reruns)."""
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.check_requests = check["requests"]
        self.device = torch.device(device)
        self.gen = traffic.generator(mix, cfg["model"]["vocab_size"], seed)
        self.batches: list[Batch] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        """Weights from the seed, the engine, and a warm-up batch of the
        mix's longest prompts: the largest shapes the window uses."""
        from repro_torch.serving.engine import Request, ServingEngine

        t0 = time.perf_counter()
        self._request = Request
        self.model = program.load_model(
            self.cfg, weights.make(self.cfg, self.seed, self.device),
            self.device)
        self.engine = ServingEngine(self.model)
        self._sync()
        t1 = time.perf_counter()
        self._generate(self.gen.warmup())
        self._sync()
        self.phases = {"weights": t1 - t0,
                       "warm-up": time.perf_counter() - t1}

    def _generate(self, prompts: list) -> list:
        return self.engine.generate([self._request(p.uid, p.tokens,
                                                   p.new_tokens)
                                     for p in prompts])

    def window(self, seconds: float) -> None:
        """Batches until ``seconds`` have passed; the window closes when the
        last batch begun in it is answered."""
        self._sync()
        self.t0 = time.perf_counter()
        i = 0
        while True:
            prompts = self.gen.batch(i)
            sent = time.perf_counter()
            done = self._generate(prompts)
            self.batches.append(Batch(prompts, done, sent,
                                      time.perf_counter()))
            i += 1
            if self.batches[-1].ended - self.t0 >= seconds:
                break
        self.t_end = self.batches[-1].ended

    def traced_segment(self):
        """More batches of the mix, one a pass of the trace."""
        from . import trace
        index = iter(range(len(self.batches), len(self.batches) + 2))
        return trace.traced(
            lambda: self._generate(self.gen.batch(next(index))),
            self.device)

    def marks(self) -> list[float]:
        """Seconds from the window's start to each of its batches' end."""
        return [b.ended - self.t0 for b in self.batches]

    def requests(self) -> tuple[int, int]:
        """(attempted, failed): a request fails that got fewer tokens
        than it asked for."""
        reqs = [(p, c) for b in self.batches
                for p, c in zip(b.prompts, b.completions)]
        return len(reqs), sum(len(c.tokens) < p.new_tokens for p, c in reqs)

    def end_to_end(self) -> dict:
        """Time to first token: from a request's sending to the end of its
        prefill (its answer's arrival less the engine's decode time), the
        median over every request of the window; tokens per second: the
        prompts' and the answers' tokens over the window."""
        ttft = [(b.ended - b.submitted - c.decode_s) * 1e3
                for b in self.batches for c in b.completions]
        tokens = sum(len(p.tokens) + len(c.tokens) for b in self.batches
                     for p, c in zip(b.prompts, b.completions))
        return {"ttft_ms.p50": statistics.median(ttft),
                "serve_tokens_per_s": tokens / (self.t_end - self.t0)}

    def free(self) -> None:
        self.engine = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The requests the check compares, drawn from the seed: one of the
        longest, then others, ``check.requests`` in all."""
        reqs = [(b, j) for b in self.batches for j in range(len(b.prompts))]
        rng = np.random.default_rng((self.seed, 7))
        lens = np.array([len(b.prompts[j].tokens) for b, j in reqs])
        longest = rng.choice(np.flatnonzero(lens == lens.max()))
        rest = [i for i in range(len(reqs)) if i != longest]
        n = min(self.check_requests, len(reqs)) - 1
        pick = [int(longest)] + [int(i) for i in
                                 rng.choice(rest, n, replace=False)]
        return [reqs[i] for i in pick]

    def check(self, precisions=("float32",)) -> dict:
        """Frees the program, then for each sampled request runs the
        reference over its prompt as served (left-padded with id 0 to its
        batch's longest, as the engine pads) and the tokens served, and
        reads by how far the reference's logit of each served token lies
        below its best at that position.  With "fp8" in ``precisions`` it
        also reads, for the control, the gap of the token the lowered
        reference puts first at each position."""
        picked = [(b.padded_len, b.prompts[j], b.completions[j])
                  for b, j in self.sample()]
        self.free()
        set_strict_float32()
        a = Arch(self.cfg["model"])
        w = weights.make(self.cfg, self.seed, self.device)
        out = {p: 0.0 for p in precisions}
        for plen, prompt, done in picked:
            served = torch.as_tensor(np.asarray(done.tokens),
                                     device=self.device)
            seq = torch.zeros(plen + len(served) - 1, dtype=torch.long,
                              device=self.device)
            seq[plen - len(prompt.tokens):plen] = torch.as_tensor(
                prompt.tokens, device=self.device)
            seq[plen:] = served[:-1]
            at = list(range(plen - 1, plen - 1 + len(served)))
            ref = decoder.logits_at(Numerics("float32"), a, self.cfg["layer"],
                                    w, seq, at)
            best = ref.max(dim=-1).values
            for prec in precisions:
                toks = served if prec == "float32" else decoder.logits_at(
                    Numerics(prec), a, self.cfg["layer"], w, seq,
                    at).argmax(-1)
                gap = (best - ref.gather(1, toks[:, None])[:, 0]).max()
                out[prec] = max(out[prec], float(gap))
        return {"logit_gap": out["float32"],
                **{f"logit_gap.{p}": v for p, v in out.items()
                   if p != "float32"}}
