"""Assigned input shapes and shape-only stand-ins for every model input.

Shapes (per assignment):
    train_4k     seq=4096    global_batch=256   -> train_step
    prefill_32k  seq=32768   global_batch=32    -> serve prefill
    decode_32k   seq=32768   global_batch=128   -> serve_step (1 new token,
                                                  KV cache of seq_len)
    long_500k    seq=524288  global_batch=1     -> serve_step; SSM/SWA archs
                                                  only (sub-quadratic)

The stand-ins are tensors on the ``meta`` device (the counterpart of
``jax.ShapeDtypeStruct``): shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import Model
from ..models.config import ArchConfig
from ..models.layers import _dtype

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524k decode skipped per assignment"
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for the step function's data inputs."""
    B, S = shape.batch, shape.seq
    dt = _dtype(cfg)
    if shape.kind == "train":
        batch = {"labels": _sds((B, S), torch.int32)}
        if cfg.frontend != "none":
            batch["embeds"] = _sds((B, S, cfg.d_model), dt)
        else:
            batch["tokens"] = _sds((B, S), torch.int32)
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = ({"embeds": _sds((B, S, cfg.d_model), dt)}
                 if cfg.frontend != "none"
                 else {"tokens": _sds((B, S), torch.int32)})
        return {"batch": batch}
    # decode: one new token against a seq_len cache
    cache = Model(cfg, device=META).init_cache(batch=B, max_len=S)
    step = ({"embeds": _sds((B, 1, cfg.d_model), dt)}
            if cfg.frontend != "none"
            else {"tokens": _sds((B, 1), torch.int32)})
    return {"cache": cache, "batch": step}


def param_specs(cfg: ArchConfig) -> dict:
    """The parameters of ``Model(cfg)`` as meta tensors, keyed by their
    ``named_parameters()`` names."""
    return dict(Model(cfg, device=META).named_parameters())
