"""The system under test as the benchmark builds it: the port's ``Model``
of a configuration, with the benchmark's weights loaded into it.  This is
the only module of the benchmark that imports the port; it imports the
port's entry points and nothing of its kernels, references or tests."""
from __future__ import annotations

import torch
from torch import nn


def arch_config(cfg: dict):
    from repro_torch.models.config import ArchConfig
    m = dict(cfg["model"])
    m["global_layers"] = tuple(m["global_layers"])
    return ArchConfig(**m)


def load_model(cfg: dict, weights: dict, device):
    """The port's ``Model`` of ``cfg`` holding ``weights`` (no copy): its
    leaves must be exactly the weights' names, shapes and dtypes."""
    from repro_torch.models import Model

    model = Model(arch_config(cfg), device="meta")
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise RuntimeError(
            f"the port's leaves and the benchmark's differ: only the port's "
            f"{sorted(set(names) - set(weights))[:5]}, only the "
            f"benchmark's {sorted(set(weights) - set(names))[:5]}")
    for name, p in names.items():
        w = weights[name]
        if tuple(p.shape) != tuple(w.shape) or p.dtype != w.dtype:
            raise RuntimeError(f"{name}: the port holds {tuple(p.shape)} "
                               f"{p.dtype}, the benchmark made "
                               f"{tuple(w.shape)} {w.dtype}")
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        owner._parameters[leaf] = nn.Parameter(w, requires_grad=False)
    if any(True for _ in model.buffers()):
        raise RuntimeError("the port's model holds buffers the benchmark "
                           "does not make")
    if model.device.type != torch.device(device).type:
        raise RuntimeError(f"model on {model.device}, asked for {device}")
    return model


def _kernels():
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     ssd_chunk, ssd_chunk_bwd)
    return {"K2": flash_attention, "K2-bwd": flash_attention_bwd,
            "K3": ssd_chunk, "K3-bwd": ssd_chunk_bwd}


def reset_launch_counts() -> None:
    """Zero the port's counts of its hand-written kernels' launches."""
    for fn in _kernels().values():
        for attr in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, attr, 0)


def launch_counts() -> dict:
    """The port's launch counts since the last reset, by kernel and route
    (``launches_sm90``, ...); no metric reads them."""
    return {f"{name}.{attr}": getattr(fn, attr)
            for name, fn in _kernels().items()
            for attr in sorted(vars(fn)) if attr.startswith("launches")
            and getattr(fn, attr)}
