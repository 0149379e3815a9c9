"""Atomic, keep-k, resumable checkpointing of a tree of tensors.

Layout (the reference's ``checkpoint/store.py``):
         <dir>/step_<N>/
            manifest.json         — leaf keys, shapes, dtypes, step
            arrays/<idx>.npy      — one file per leaf, on the host
         <dir>/LATEST             — atomically updated pointer

A tree is nested dicts with tensor leaves; a leaf's key is its path joined
by ``/`` (dict keys in sorted order, as JAX flattens them).  Writes go to
``step_<N>.tmp`` then ``os.replace``: a crash mid-save never corrupts the
previous checkpoint.  numpy has no bfloat16, so a bf16 tensor is stored as
its 16-bit pattern (``uint16``) with ``"bfloat16"`` in the manifest.

``restore`` copies into the tensors of the tree it is given, in place, on
their own devices and in their own dtypes (as ``nn.Module.load_state_dict``
does): a model whose parameters are leaves of the tree sees the restored
values without being rebuilt.  A ``DTensor`` leaf takes its own slice.
``restore(..., shardings=)`` instead re-places each leaf as a ``DTensor`` by
its ``distributed.sharding.NamedSharding`` (any mesh: the files hold full
values) and returns a new tree.

A tree holding ``DTensor`` leaves is saved by every rank of the program
together: each such leaf's full value is gathered, rank 0 alone writes,
and all ranks wait for the write to finish.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

_BF16 = "bfloat16"


def flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, leaf) pairs of a nested dict of tensors, keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}/")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a torch.Tensor")
    return [(prefix[:-1], tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    if isinstance(t, DTensor):
        from ..distributed.sharding import gather
        t = gather(t.detach())
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str | os.PathLike, step: int, tree, *,
         keep: int = 3) -> Path:
    leaves = flatten(tree)
    if any(isinstance(leaf, DTensor) for _, leaf in leaves):
        arrays = [_to_numpy(leaf) for _, leaf in leaves]   # every rank
        final = Path(directory) / f"step_{step:08d}"
        if dist.get_rank() == 0:
            _write(directory, step, leaves, arrays, keep)
        dist.barrier()
        return final
    return _write(directory, step, leaves,
                  [_to_numpy(leaf) for _, leaf in leaves], keep)


def _write(directory, step: int, leaves, arrays, keep: int) -> Path:
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)

    manifest = {"step": step, "leaves": []}
    for i, ((key, leaf), (arr, dtype)) in enumerate(zip(leaves, arrays)):
        np.save(tmp / "arrays" / f"{i}.npy", arr)
        manifest["leaves"].append(
            {"key": key, "index": i, "shape": list(leaf.shape),
             "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    # atomic LATEST pointer
    fd, tmppath = tempfile.mkstemp(dir=base)
    with os.fdopen(fd, "w") as f:
        f.write(final.name)
    os.replace(tmppath, base / "LATEST")

    _garbage_collect(base, keep)
    return final


def _garbage_collect(base: Path, keep: int) -> None:
    ckpts = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    base = Path(directory)
    ptr = base / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (base / name / "manifest.json").exists():
        # stale pointer (crash between replace calls): fall back to scan
        ckpts = sorted(p for p in base.iterdir()
                       if p.is_dir() and (p / "manifest.json").exists())
        if not ckpts:
            return None
        name = ckpts[-1].name
    return int(name.split("_")[1])


@torch.no_grad()
def restore(directory: str | os.PathLike, tree, *,
            step: int | None = None, shardings=None):
    """Copy checkpoint ``step`` (the latest when None) into the tensors of
    ``tree``, in place, each on its own device and in its own dtype (a
    ``DTensor`` leaf: its local slice).  With ``shardings`` (a tree of the
    same keys whose leaves are ``NamedSharding``s) each leaf is instead
    re-placed as a new ``DTensor`` in its own dtype on the sharding's mesh,
    and a new tree is returned.  Returns ``(tree, step)``.  Raises
    ``FileNotFoundError`` when there is no checkpoint, ``KeyError`` for a
    leaf the checkpoint lacks and ``ValueError`` for a shape that
    disagrees; nothing is written unless every leaf checks out."""
    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    ckpt = base / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}

    leaves = flatten(tree)
    for key, leaf in leaves:        # check every leaf before writing any
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        shape = tuple(by_key[key]["shape"])
        if shape != tuple(leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {shape} != {tuple(leaf.shape)}")
    if shardings is not None:
        return _place(tree, shardings, ckpt, by_key), step
    for key, leaf in leaves:
        full = _load(ckpt, by_key[key])
        if isinstance(leaf, DTensor):
            from ..distributed.sharding import local_slice
            leaf.to_local().copy_(local_slice(full, leaf.device_mesh,
                                              tuple(leaf.placements)))
        else:
            leaf.copy_(full)
    return tree, step


def _load(ckpt: Path, m: dict) -> torch.Tensor:
    arr = np.load(ckpt / "arrays" / f"{m['index']}.npy")
    return _from_numpy(arr, m["dtype"])


def _place(tree, shardings, ckpt: Path, by_key: dict, prefix: str = ""):
    """``tree``'s structure with each leaf loaded and placed by the
    sharding at the same keys, in the leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _place(tree[k], shardings[k], ckpt, by_key,
                          f"{prefix}{k}/") for k in tree}
    full = _load(ckpt, by_key[prefix[:-1]])
    return shardings.place(full.to(shardings.mesh.device_type, tree.dtype))
