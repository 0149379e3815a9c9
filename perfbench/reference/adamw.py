"""AdamW as a configuration states it, plain: the learning rate from its
schedule, the gradients clipped by their global norm, both moments and the
bias corrections in float32, decoupled weight decay on the leaves the
configuration names, and the moments and the parameters kept in the dtypes
it states (rounded after each step)."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def learning_rate(schedule: dict, step: int) -> torch.Tensor:
    """"cosine": linear warm-up to ``peak`` over ``warmup`` steps, then a
    half cosine down to ``floor`` x ``peak`` at ``total``; in float32."""
    if schedule["kind"] != "cosine":
        raise ValueError(f"unknown schedule {schedule['kind']!r}")
    s = torch.tensor(float(step), dtype=F32)
    peak, warmup, total = (schedule["peak"], schedule["warmup"],
                           schedule["total"])
    if step < warmup:
        return peak * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    floor = schedule["floor"]
    return peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))


def decays(name: str, shape, rule: str) -> bool:
    """Whether leaf ``name`` takes weight decay under ``rule``:
    "layers_and_matrices" is every leaf of a layer and every other leaf of
    two or more dims (the embedding and the head, not the final norm)."""
    if rule != "layers_and_matrices":
        raise ValueError(f"unknown weight-decay rule {rule!r}")
    return name.startswith("layers.") or len(shape) >= 2


class AdamW:
    def __init__(self, opt: dict, params: dict, dtypes: dict):
        """``params``: float32 leaves holding values of ``dtypes`` (each
        leaf's stored dtype), which every step rounds them back to."""
        self.o = opt
        self.state_dtype = getattr(torch, opt["state_dtype"])
        self.dtypes = dtypes
        self.step = 0
        self.m = {k: torch.zeros(p.shape, dtype=self.state_dtype,
                                 device=p.device) for k, p in params.items()}
        self.v = {k: torch.zeros_like(m) for k, m in self.m.items()}

    @torch.no_grad()
    def update(self, params: dict) -> dict:
        """One step from each leaf's ``.grad`` (freed as it is used);
        returns each leaf's clipped gradient norm, as the moments take it."""
        o = self.o
        self.step += 1
        gnorm = torch.sqrt(sum((p.grad.to(F32) ** 2).sum()
                               for p in params.values()))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = learning_rate(o["schedule"], self.step).to(scale.device)
        bc1 = 1 - o["b1"] ** self.step
        bc2 = 1 - o["b2"] ** self.step
        norms = {}
        for k, p in params.items():
            g = p.grad.to(F32) * scale
            p.grad = None
            norms[k] = float(torch.linalg.vector_norm(g))
            m = o["b1"] * self.m[k].to(F32) + (1 - o["b1"]) * g
            v = o["b2"] * self.v[k].to(F32) + (1 - o["b2"]) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"])
            if decays(k, p.shape, o["decay"]):
                delta = delta + o["weight_decay"] * p
            p.copy_((p - lr * delta).to(self.dtypes[k]).to(F32))
            self.m[k].copy_(m.to(self.state_dtype))
            self.v[k].copy_(v.to(self.state_dtype))
        return norms
