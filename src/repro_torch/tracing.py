"""The port's tracing: ``span(name)`` at each layer a trace measures.

A span is the profiler's range ``torch.profiler.record_function(name)``:
under ``torch.profiler`` the kernels launched while it is open on its
thread are credited to it; with no profiler it costs what the range costs.
Every range of the port is opened here.

The spans, where they are and who reads them:

* ``model.decode_step`` (``models.transformer.Model.decode_step``);
* ``train_step.forward`` (``model.loss``), ``train_step.backward``
  (``loss.backward()``) and ``train_step.optimizer`` (the optimizer's
  update), in ``training.step.make_train_step``;
* ``transformer.layer``: each layer's forward and remat's recompute;
  ``moe.router``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``.
"""
from __future__ import annotations

from torch.profiler import record_function


def span(name: str) -> record_function:
    """A context manager: the profiler's range ``name``."""
    return record_function(name)
