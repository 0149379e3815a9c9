"""Train / serve step builders (the reference's ``training/step.py``).

The parameters live in the ``Model``; a training state is the tree
``{"params": {name: parameter}, "opt": optimizer state}`` whose parameter
leaves are the model's own ``nn.Parameter`` objects, so the optimizer's
in-place update and ``checkpoint.store.restore`` both act on the model.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import Model
from ..models.config import ArchConfig
from ..models.convert import layer_groups
from ..tracing import span
from .optim import AdamW, FactoredAdam, cosine_schedule


def default_optimizer(cfg: ArchConfig):
    """bf16 AdamW states by default; factored second moment for ≥100B params
    (the 400B-class archs can't hold full Adam states on one pod)."""
    lr = cosine_schedule(3e-4, warmup=200, total=10_000)
    if cfg.param_count() > 100e9:
        return FactoredAdam(learning_rate=lr, layer_groups=layer_groups(cfg))
    return AdamW(learning_rate=lr, state_dtype=torch.bfloat16)


def init_state(model: Model, optimizer) -> dict:
    """Turn on gradients for the model's parameters and build the training
    state around them (the weights themselves come from the model's
    generator)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": optimizer.init(params)}


def make_train_step(model: Model, optimizer) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: zero the grads, run
    ``model.loss`` and its backward, apply the optimizer in place; metrics
    are the optimizer's (``grad_norm``, ``lr``) plus ``loss``, as 0-d
    tensors on the model's device.  The three phases run under the spans
    ``train_step.forward``, ``train_step.backward`` and
    ``train_step.optimizer`` (``tracing``), so a trace attributes their
    device time."""
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        for p in params.values():
            p.grad = None
        with span("train_step.forward"):
            loss = model.loss(batch)
        with span("train_step.backward"):
            loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        with span("train_step.optimizer"):
            new_params, new_opt, metrics = optimizer.update(
                grads, state["opt"], params)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss.detach()
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(batch):
        return model.loss(batch)
    return eval_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(cache, batch):
        return model.decode_step(cache, batch)
    return serve_step
