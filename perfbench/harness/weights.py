"""The weights of a configuration, made from ``--seed`` on the device.

The normal-distributed leaves of the model's dtype lie in one flat buffer
drawn in chunks of ``CHUNK`` elements, each from a generator seeded by
(seed, chunk), and are scaled leaf by leaf in place; the float32 leaves
of the SSM's decays and steps come from one draw of uniforms.  The same
seed on the same device gives the same tensors, so the reference gets
them again after the program's state is freed.
"""
from __future__ import annotations

import math

import torch

from ..reference.common import Arch
from ..reference.decoder import spec

CHUNK = 1 << 27
F32 = torch.float32
_NORMAL = ("normal", "out", "conv")
_FLOAT32 = ("a_log", "dt_bias", "ones32")


def _generator(device, seed: int, stream: int) -> torch.Generator:
    mixed = (seed * 1_000_003 + stream * 7_919 + 12_345) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def leaf_dtypes(cfg: dict) -> dict:
    """Each leaf's stored dtype: the model's, but float32 for the SSM's
    decays, steps and skip (as the system under test keeps them)."""
    a, dt = Arch(cfg["model"]), getattr(torch, cfg["model"]["dtype"])
    return {k: F32 if kind in _FLOAT32 else dt
            for k, (_, kind) in spec(a, cfg["layer"]).items()}


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    a = Arch(cfg["model"])
    init = cfg["init"]
    leaves = spec(a, cfg["layer"])
    dtypes = leaf_dtypes(cfg)
    scales = {"normal": init["std"],
              "out": init["std"] / math.sqrt(2 * a.num_layers),
              "conv": init["conv_std"]}
    normal = [(k, shape, kind) for k, (shape, kind) in leaves.items()
              if kind in _NORMAL]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.empty(total, dtype=getattr(torch, a.dtype), device=device)
    for i, start in enumerate(range(0, total, CHUNK)):
        flat[start:start + CHUNK].normal_(
            generator=_generator(device, seed, i))
    out: dict[str, torch.Tensor] = {}
    at = 0
    for k, shape, kind in normal:
        n = math.prod(shape)
        out[k] = flat[at:at + n].view(shape).mul_(scales[kind])
        at += n
    special = [(k, shape[0], kind) for k, (shape, kind) in leaves.items()
               if kind in ("a_log", "dt_bias")]
    u = torch.rand(sum(n for _, n, _ in special), dtype=F32, device=device,
                   generator=_generator(device, seed, -1))
    at = 0
    for k, n, kind in special:
        x = u[at:at + n]
        at += n
        if kind == "a_log":
            out[k] = torch.log(init["a_min"] + x * (init["a_max"]
                                                    - init["a_min"]))
        else:
            lo, hi = math.log(init["dt_min"]), math.log(init["dt_max"])
            dt = torch.exp(lo + x * (hi - lo))
            out[k] = dt + torch.log(-torch.expm1(-dt))   # softplus⁻¹(dt)
    for k, (shape, kind) in leaves.items():
        if kind in ("ones", "ones32"):
            out[k] = torch.ones(shape, dtype=dtypes[k], device=device)
        elif kind == "zeros":
            out[k] = torch.zeros(shape, dtype=dtypes[k], device=device)
    return {k: out[k] for k in leaves}
