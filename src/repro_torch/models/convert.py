"""Load the reference's parameter tree into the port's ``Model``.

The reference keeps parameters as a nested dict whose layer leaves are
stacked along a leading ``num_layers`` axis; the port keeps one module per
layer with the same leaf names, so leaf ``layers/attn/wq`` row ``i`` is the
port's ``layers.{i}.attn.wq``.  A config whose layers come in groups of g
sub-layers (llama4: ``moe_every`` = 2, dense then MoE) stacks each
sub-layer ``s{i}`` over the num_layers / g groups: row j of
``layers/s{i}/...`` is the port's layer ``j * g + i`` (``reference_leaf``).
This is the one way the tests share weights between the two packages, and
the map by which the optimizers give a per-layer leaf the reference's
stacked rank.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import Model, _sub_cfgs


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


def reference_leaf(name: str, groups: int = 1) -> tuple[str, int | None]:
    """(the reference's leaf, row) of the port's parameter ``name``: layer
    j's ``layers.{j}.rest`` is row j // g of ``layers.s{j % g}.rest`` for
    ``groups`` g > 1, of ``layers.rest`` for g = 1; any other leaf is the
    same name, row None."""
    head, _, tail = name.partition(".")
    index, _, rest = tail.partition(".")
    if head != "layers" or not index.isdigit() or not rest:
        return name, None
    j = int(index)
    sub = f"s{j % groups}." if groups > 1 else ""
    return f"layers.{sub}{rest}", j // groups


def layer_groups(cfg: ArchConfig) -> int:
    """Sub-layers a group of layers has (llama4: 2), each stacked on its
    own in the reference."""
    return len(_sub_cfgs(cfg))


def params_from_reference(cfg: ArchConfig, tree: dict, *,
                          device="cuda") -> Model:
    """A ``Model`` of ``cfg`` on ``device`` holding the reference tree's
    values (numpy arrays, or anything ``np.asarray`` takes).  The default
    device is the card, as ``Model``'s: without one it raises unless
    ``device="cpu"`` is given.  Raises if a leaf is missing or left over,
    or if a shape disagrees."""
    model = Model(cfg, device=device)
    g = layer_groups(cfg)
    groups = cfg.num_layers // g
    state = {}
    for name, val in _flatten(tree).items():
        if name.startswith("layers."):
            stacked = _tensor(val)
            rest = name[len("layers."):]
            sub = 0
            if g > 1:
                head, _, rest = rest.partition(".")
                if head not in {f"s{i}" for i in range(g)}:
                    raise ValueError(f"{name}: not under one of the {g} "
                                     f"sub-layers s0..s{g - 1}")
                sub = int(head[1:])
            if stacked.shape[0] != groups:
                raise ValueError(f"{name}: leading axis {stacked.shape[0]} "
                                 f"is not num_layers / {g} = {groups}")
            for j in range(groups):   # reference_leaf's map, inverted
                state[f"layers.{j * g + sub}.{rest}"] = stacked[j]
        else:
            state[name] = _tensor(val)
    model.load_state_dict(state, strict=True)
    return model
