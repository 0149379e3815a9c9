"""Load the reference's parameter tree into the port's ``Model``.

The reference keeps parameters as a nested dict whose layer leaves are
stacked along a leading ``num_layers`` axis; the port keeps one module per
layer with the same leaf names, so leaf ``layers/attn/wq`` row ``i`` is the
port's ``layers.{i}.attn.wq``.  This is the one way the tests share weights
between the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import Model


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def params_from_reference(cfg: ArchConfig, tree: dict, *,
                          device="cpu") -> Model:
    """A ``Model`` of ``cfg`` on ``device`` holding the reference tree's
    values (numpy arrays, or anything ``np.asarray`` takes).  Raises if a
    leaf is missing or left over, or if a shape disagrees."""
    model = Model(cfg, device=device)
    state = {}
    for name, val in _flatten(tree).items():
        if name.startswith("layers."):
            stacked = _tensor(val)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {stacked.shape[0]} "
                                 f"is not num_layers={cfg.num_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.num_layers):
                state[f"layers.{i}.{rest}"] = stacked[i]
        else:
            state[name] = _tensor(val)
    model.load_state_dict(state, strict=True)
    return model
