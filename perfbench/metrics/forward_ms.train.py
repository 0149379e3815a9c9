"""Device time under the port's ``train_step.forward`` span (``Model.loss``:
the layers' forward and the loss head), per traced step, in ms: the
kernels whose launching operator began while the span was open on its
thread, as ``ranges`` credits a range.  None where the program has no such
span."""


def read(ctx):
    t = ctx.trace
    if t is None or "train_step.forward" not in t.ranges:
        return None
    return 1e3 * t.ranges["train_step.forward"] / ctx.run.traced_steps
