"""Fault tolerance for a training loop, on one card or under a mesh.

``FaultTolerantRunner`` wraps a step function with:
* periodic checkpointing (atomic, keep-k — see ``checkpoint.store``);
* retry-with-restore on step failure (simulating preempted/failed workers);
* re-homing: ``remesh(device)`` checkpoints, moves the state's tensors to
  ``device`` and restores the checkpoint into them; ``remesh(shardings)``
  (a tree of ``distributed.sharding.NamedSharding`` matching the state, on
  a new mesh) checkpoints and restores with them, as the reference's
  ``remesh(new_shardings)``: checkpoints hold full values, so any mesh
  shape works.  Given a ``HeteroBatchScheduler`` it also routes the pods
  lost or joined through the scheduler's change-point path (``pod_leave``
  / ``pod_join``).

The state is a tree of tensors (nested dicts) that ``checkpoint.store``
restores in place, so a model whose parameters are leaves of it follows
every restore on a device.  A restore with shardings builds new
``DTensor`` leaves: the step function reads them from the state.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterator

import torch

from ..checkpoint import store

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RunnerConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    max_retries_per_step: int = 2
    max_total_restarts: int = 10


class StepFailure(RuntimeError):
    """Raised by a step to simulate a worker failure / preemption."""


class FaultTolerantRunner:
    def __init__(self, cfg: RunnerConfig, *,
                 step_fn: Callable[[Any, dict], tuple[Any, dict]],
                 state: Any):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.restore_shardings = None       # set by remesh(shardings)
        self.step = 0
        self.restarts = 0
        self.step_times: list[float] = []

    # -- checkpoint/restore -------------------------------------------------

    def maybe_checkpoint(self, force: bool = False) -> None:
        if force or (self.step > 0 and
                     self.step % self.cfg.checkpoint_every == 0):
            store.save(self.cfg.checkpoint_dir, self.step, self.state,
                       keep=self.cfg.keep)

    def restore_latest(self) -> bool:
        try:
            self.state, self.step = store.restore(
                self.cfg.checkpoint_dir, self.state,
                shardings=self.restore_shardings)
            return True
        except FileNotFoundError:
            return False

    # -- main loop ----------------------------------------------------------

    def run(self, batches: Iterator[dict], num_steps: int,
            on_metrics: Callable[[int, dict], None] | None = None) -> Any:
        it = iter(batches)
        while self.step < num_steps:
            try:
                batch = next(it)
            except StopIteration:
                # the batch stream can run dry before num_steps (finite
                # datasets, truncated replays): stop cleanly with a final
                # checkpoint instead of leaking StopIteration to the caller
                log.warning("batch stream exhausted at step %d/%d; stopping",
                            self.step, num_steps)
                break
            retries = 0
            while True:
                try:
                    t0 = time.perf_counter()
                    self.state, metrics = self.step_fn(self.state, batch)
                    dt = time.perf_counter() - t0
                    self.step_times.append(dt)
                    break
                except StepFailure as e:
                    retries += 1
                    self.restarts += 1
                    log.warning("step %d failed (%s); restoring (retry %d)",
                                self.step, e, retries)
                    if (retries > self.cfg.max_retries_per_step or
                            self.restarts > self.cfg.max_total_restarts):
                        raise
                    if not self.restore_latest():
                        log.warning("no checkpoint yet; retrying from "
                                    "current state")
            self.step += 1
            if on_metrics:
                on_metrics(self.step, metrics)
            self.maybe_checkpoint()
        self.maybe_checkpoint(force=True)
        return self.state

    # -- re-homing ------------------------------------------------------------

    @torch.no_grad()
    def remesh(self, target, *, scheduler: Any = None,
               lost: tuple = (), joined: tuple = ()) -> None:
        """Rebuild the state elsewhere (e.g. after losing a card or a
        pod): checkpoint now, then, for a device ``target``, re-home every
        tensor of the state on it (same objects: a model's parameters stay
        its parameters) and restore the checkpoint into them; for a tree of
        shardings, restore the checkpoint with them (new ``DTensor``
        leaves; later restores use them too).

        When the training loop splits batches with a
        ``HeteroBatchScheduler``, pass it (plus the departed pod names /
        joined ``PodProfile``s) and the same call routes the membership
        change through the POAS change-point path (``pod_leave`` /
        ``pod_join`` — re-fitted models carried for survivors, plan cache
        invalidated), so the very next step's batch split is solved on
        the new cluster instead of the stale one."""
        self.maybe_checkpoint(force=True)
        if scheduler is not None:
            for name in lost:
                scheduler.pod_leave(name)
            for pod in joined:
                scheduler.pod_join(pod)
        if isinstance(target, (str, torch.device)):
            for _, leaf in store.flatten(self.state):
                leaf.data = torch.empty_like(leaf.data, device=target)
            self.restore_shardings = None
        else:
            self.restore_shardings = target
        self.state, self.step = store.restore(
            self.cfg.checkpoint_dir, self.state,
            shardings=self.restore_shardings)
