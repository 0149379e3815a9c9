"""The share of the traced segment's wall time in which no operation ran
on the device, in %."""
from perfbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
