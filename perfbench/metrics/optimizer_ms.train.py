"""Device time under the port's ``train_step.optimizer`` range, per traced
step, in ms."""


def read(ctx):
    t = ctx.trace
    if t is None or "train_step.optimizer" not in t.ranges:
        return None
    return 1e3 * t.ranges["train_step.optimizer"] / ctx.run.traced_steps
