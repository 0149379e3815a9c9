"""A training cell: the port's training step, built once in set-up and
driven from the seed through its first steps, then timed on the steps that
follow; the first steps held against the plain reference's."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import decoder
from ..reference.adamw import AdamW as RefAdamW
from ..reference.common import Arch
from ..reference.numerics import Numerics, set_strict_float32
from . import program, traffic, weights

F32 = torch.float32


def _norms(tensors: dict, minus: dict | None = None) -> dict:
    """Each tensor's float32 norm (of its difference from ``minus``'s
    tensor of the same name), leaf by leaf, read back in one transfer."""
    keys = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(
        tensors[k].detach().to(F32) - (0 if minus is None
                                       else minus[k].to(F32)))
        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _change(cfg: dict, seed: int, device, params: dict) -> dict:
    """Each leaf's norm of its change from the seed's weights."""
    return _norms(params, weights.make(cfg, seed, device))


class Readings:
    """What the check compares of one side's first steps: each step's
    loss, each leaf's first clipped gradient norm, and after the steps
    each leaf's norm of change and the norms of its two moments."""

    def __init__(self, losses: list, grad: dict, change: dict, m: dict,
                 v: dict):
        self.losses, self.grad, self.change = losses, grad, change
        self.m, self.v = m, v


def _leaf_gap(got: dict, ref: dict) -> dict:
    """Each leaf's gap of norms, against the larger of the reference's
    norm of that leaf and of the median leaf."""
    med = float(np.median(list(ref.values())))
    return {k: abs(got[k] - r) / max(r, med) for k, r in ref.items()}


def worst(got: Readings, ref: Readings) -> dict:
    """The leaves that set ``gaps``' gradient and change numbers."""
    gmed = float(np.median(list(ref.grad.values())))
    out = {}
    for name in ("grad", "change", "m", "v"):
        leaf = _leaf_gap(getattr(got, name), getattr(ref, name))
        if name == "change":
            leaf = {k: g for k, g in leaf.items()
                    if ref.grad[k] >= 1e-3 * gmed}
        out[name] = max(leaf, key=leaf.get)
    return out


def gaps(got: Readings, ref: Readings) -> dict:
    """The worst relative gaps of ``got`` from ``ref``: of a step's loss;
    of a leaf's norm of gradient, of change and of each moment, each
    against the larger of that leaf's reference norm and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses))
    gmed = float(np.median(list(ref.grad.values())))
    change = _leaf_gap(got.change, ref.change)
    return {"loss_gap": loss,
            "grad_gap": max(_leaf_gap(got.grad, ref.grad).values()),
            "change_gap": max((g for k, g in change.items()
                               if ref.grad[k] >= 1e-3 * gmed), default=0.0),
            "m_gap": max(_leaf_gap(got.m, ref.m).values()),
            "v_gap": max(_leaf_gap(got.v, ref.v).values())}


class TrainCell:
    kind = "train"
    traced_steps = 2

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                  check: dict):
        """``check``: the cell's check sizes (``steps``, the first steps
        the reference follows)."""
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.check_steps = check["steps"]
        self.device = torch.device(device)
        self.data = traffic.generator(mix, cfg["model"]["vocab_size"], seed)
        self.step_times: list[float] = []
        self.losses: list = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _upload(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def setup(self) -> None:
        """Weights from the seed, the port's AdamW and train step, and the
        mix's first ``check.steps`` steps through the step the window
        times: they warm it up, and the check reads them."""
        from repro_torch.training import (AdamW, cosine_schedule, init_state,
                                          make_train_step)

        o, sched = self.cfg["optimizer"], self.cfg["optimizer"]["schedule"]
        t0 = time.perf_counter()
        self.model = program.load_model(
            self.cfg, weights.make(self.cfg, self.seed, self.device),
            self.device)
        if sched["kind"] != "cosine":
            raise ValueError(f"unknown schedule {sched['kind']!r}")
        lr = cosine_schedule(sched["peak"], warmup=sched["warmup"],
                             total=sched["total"], floor=sched["floor"])
        self.opt = AdamW(learning_rate=lr, b1=o["b1"], b2=o["b2"],
                         eps=o["eps"], weight_decay=o["weight_decay"],
                         clip_norm=o["clip_norm"],
                         state_dtype=getattr(torch, o["state_dtype"]))
        self.state = init_state(self.model, self.opt)
        self.step_fn = make_train_step(self.model, self.opt)
        self._sync()
        t1 = time.perf_counter()
        losses = []
        for s in range(self.check_steps):
            self.state, met = self.step_fn(self.state,
                                           self._upload(self.data.batch(s)))
            losses.append(met["loss"])
            if s == 0:
                grad = {k: v / (1 - o["b1"]) for k, v in
                        _norms(self.state["opt"]["m"]).items()}
        self.program = Readings([float(x) for x in losses], grad,
                                _change(self.cfg, self.seed, self.device,
                                        self.state["params"]),
                                _norms(self.state["opt"]["m"]),
                                _norms(self.state["opt"]["v"]))
        self.next = self.check_steps
        self._sync()
        self.phases = {"weights and optimizer": t1 - t0,
                       "first steps": time.perf_counter() - t1}

    def _run(self, steps: int | None, seconds: float) -> float:
        """Steps from the next one on: ``steps`` of them, or until
        ``seconds`` have passed (the last step begun in them ends the
        window).  The next batch is drawn on the host while the device
        runs a step.  Returns the host clock at the first step's start."""
        batch = self._upload(self.data.batch(self.next))
        self._sync()
        t0, before = time.perf_counter(), len(self.step_times)
        while True:
            self.state, met = self.step_fn(self.state, batch)
            self.next += 1
            nxt = self.data.batch(self.next)
            self._sync()
            self.step_times.append(time.perf_counter())
            self.losses.append(met["loss"])
            done = len(self.step_times) - before
            if (steps is not None and done >= steps) or (
                    steps is None and self.step_times[-1] - t0 >= seconds):
                break
            batch = self._upload(nxt)
        return t0

    def window(self, seconds: float) -> None:
        self.t0 = self._run(None, seconds)
        self.t_end = self.step_times[-1]
        self.window_steps = len(self.step_times)

    def traced_segment(self):
        """``traced_steps`` more steps a pass of the trace."""
        from . import trace
        return trace.traced(lambda: self._run(self.traced_steps, 0.0),
                            self.device)

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]

    def marks(self) -> list[float]:
        """Seconds from the window's start to each of its steps' end."""
        return [t - self.t0 for t in self.step_times[:self.window_steps]]

    def requests(self) -> tuple[int, int]:
        """(attempted, failed): the window's steps, and those whose loss
        is not finite."""
        losses = [float(x) for x in self.losses[:self.window_steps]]
        return len(losses), sum(not np.isfinite(x) for x in losses)

    def end_to_end(self) -> dict:
        return {"train_tokens_per_s": self.window_steps * self.tokens_per_step
                / (self.t_end - self.t0)}

    def free(self) -> None:
        self.model = self.opt = self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32",
                  rows: slice = slice(None)) -> Readings:
        """The reference's first ``check.steps`` steps from the seed's
        weights on the same batches (``rows`` of each), in float32 leaves
        rounded to the configuration's dtypes after each step."""
        a, nx = Arch(self.cfg["model"]), Numerics(precision)
        w = weights.make(self.cfg, self.seed, self.device)
        params = {k: v.to(F32).requires_grad_() for k, v in w.items()}
        del w
        opt = RefAdamW(self.cfg["optimizer"], params,
                       weights.leaf_dtypes(self.cfg))
        losses, grad = [], None
        for s in range(self.check_steps):
            b = self._upload(self.data.batch(s, rows))
            loss = decoder.loss(nx, a, self.cfg["layer"], params,
                                b["tokens"], b["labels"])
            loss.backward()
            losses.append(float(loss.detach()))
            norms = opt.update(params)
            grad = grad or norms
        m, v = _norms(opt.m), _norms(opt.v)
        del opt
        gc.collect()
        return Readings(losses, grad,
                        _change(self.cfg, self.seed, self.device, params),
                        m, v)

    def check(self, precisions=("float32",), faults=()) -> dict:
        """Frees the program and holds its first steps against the
        reference's.  For the control and the faults (calibration only):
        each precision in ``precisions`` past float32 and each fault
        ("half_batch": the reference on the first half of each batch's
        rows) read against the float32 reference."""
        self.free()
        set_strict_float32()
        ref = self.reference()
        out = gaps(self.program, ref)
        self.detail = {"program_losses": self.program.losses,
                       "reference_losses": ref.losses,
                       "worst": worst(self.program, ref)}
        for prec in precisions:
            if prec != "float32":
                out.update({f"{k}.{prec}": v for k, v in
                            gaps(self.reference(prec), ref).items()})
        if "half_batch" in faults:
            half = slice(0, self.mix["batch"] // 2)
            out.update({f"{k}.half_batch": v for k, v in
                        gaps(self.reference(rows=half), ref).items()})
        return out
