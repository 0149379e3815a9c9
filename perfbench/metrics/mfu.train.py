"""The training step's share of the chip's peak: the model operations of
the window's steps (three forwards a step, ``costs.model``) over the
window's wall time times the peak rate, in %."""
from perfbench.costs.model import train_step_flops


def read(ctx):
    r = ctx.run
    flops = r.window_steps * train_step_flops(
        ctx.config["model"], ctx.mix["batch"], ctx.mix["seq_len"])
    return 100.0 * flops / ((r.t_end - r.t0) * ctx.peaks["flops_per_s"])
