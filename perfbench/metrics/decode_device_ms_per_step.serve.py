"""Device time a decode step, in ms: the kernels launched under the port's
``model.decode_step`` span in the traced batch with host operations (as
``ranges`` credits a range) over that batch's ``new_tokens - 1`` steps.
Beside ``decode_ms_per_step.serve``, the engine's wall time a step, it
tells the device's share of a step from the host's.  None where the
program has no such span."""


def read(ctx):
    t = ctx.trace
    steps = ctx.mix["new_tokens"] - 1
    if t is None or "model.decode_step" not in t.ranges or steps <= 0:
        return None
    return 1e3 * t.ranges["model.decode_step"] / steps
