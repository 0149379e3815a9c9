"""The plain reference of a decoder-only language model, float32.

token embedding; per layer x += mixer(norm(x)), then, where the layer has
one, x += ffn(norm(x)); a final norm; the head (the embedding's transpose
where they are tied).  The mixer and the feed-forward block are modules of
this package named by the configuration's ``layer`` section
(``{"mixer": "mla", "ffn": "mlp"}``): a new kind of block is a new module
beside ``mla.py``, ``ssm.py`` and ``mlp.py``.

The leaves carry the names of the system under test's parameters
(``layers.3.attn.wq_a``), so one set of tensors made from a seed loads
into both.  Nothing here imports the system under test.
"""
from __future__ import annotations

import importlib

import torch
from torch.utils.checkpoint import checkpoint

from .common import F32, Arch, rmsnorm

# where a layer's norms sit before its two sub-blocks
_NORMS = ("ln1", "ln2")


def blocks(layer: dict) -> list:
    """The block modules of one layer: its mixer, then its feed-forward
    block if it has one."""
    return [importlib.import_module(f"{__package__}.{layer[k]}")
            for k in ("mixer", "ffn") if layer.get(k)]


def spec(a: Arch, layer: dict) -> dict:
    """Every leaf: name -> (shape, init), in a fixed order."""
    out = {"embed": ((a.vocab_size, a.d_model), "normal")}
    mods = blocks(layer)
    for i in range(a.num_layers):
        for norm, mod in zip(_NORMS, mods):
            out[f"layers.{i}.{norm}.scale"] = ((a.d_model,), "ones")
            for k, v in mod.spec(a).items():
                out[f"layers.{i}.{mod.PREFIX}.{k}"] = v
    out["final_norm.scale"] = ((a.d_model,), "ones")
    if not a.tie_embeddings:
        out["lm_head"] = ((a.d_model, a.vocab_size), "normal")
    return out


def _layer(params: dict, i: int) -> dict:
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _sub(leaves: dict, prefix: str) -> dict:
    pre = prefix + "."
    return {k[len(pre):]: v.to(F32) for k, v in leaves.items()
            if k.startswith(pre)}


def layer_forward(nx, a: Arch, mods: list, leaves: dict, x, positions):
    for norm, mod in zip(_NORMS, mods):
        h = rmsnorm(x, leaves[f"{norm}.scale"].to(F32), a.norm_eps)
        x = x + mod.forward(nx, _sub(leaves, mod.PREFIX), h, a, positions)
    return x


def head(params: dict, a: Arch) -> torch.Tensor:
    return (params["embed"].T if a.tie_embeddings else params["lm_head"])


@torch.no_grad()
def logits_at(nx, a: Arch, layer: dict, params: dict, tokens: torch.Tensor,
              positions: list[int]) -> torch.Tensor:
    """The logits (len(positions), V) of one sequence ``tokens`` (S,) at
    ``positions``, each layer's leaves widened to float32 as it runs."""
    mods = blocks(layer)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens].to(F32)[None]
    for i in range(a.num_layers):
        x = layer_forward(nx, a, mods, _layer(params, i), x, pos)
    h = rmsnorm(x[0, positions], params["final_norm.scale"].to(F32),
                a.norm_eps)
    return nx.mm(h, head(params, a).to(F32))


def _xent_sum(nx, h, w, labels):
    logits = nx.mm(h, w)
    keep = labels >= 0
    ll = logits.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    return ((torch.logsumexp(logits, dim=-1) - ll) * keep).sum()


def loss(nx, a: Arch, layer: dict, params: dict, tokens: torch.Tensor,
         labels: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy over ``labels`` >= 0, with autograd
    through ``params`` (float32 leaves); each layer and each ``chunk``
    tokens of the head recomputed in the backward, so the activations of
    one layer and one chunk of logits are held at a time."""
    mods = blocks(layer)
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens]
    for i in range(a.num_layers):
        x = checkpoint(layer_forward, nx, a, mods, _layer(params, i), x, pos,
                       use_reentrant=False)
    h = rmsnorm(x, params["final_norm.scale"], a.norm_eps).reshape(B * S, -1)
    y = labels.reshape(B * S).long()
    w = head(params, a)
    total = sum(checkpoint(_xent_sum, nx, h[i:i + chunk], w, y[i:i + chunk],
                           use_reentrant=False)
                for i in range(0, B * S, chunk))
    return total / (y >= 0).sum().clamp(min=1)
