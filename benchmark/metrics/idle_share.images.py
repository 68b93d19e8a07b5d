"""The share of the profiled stretch's wall time in which no operation
(kernel, copy, set) ran on the card, in %: the device layer
(`layers.idle_share`)."""

from benchmark.layers import idle_share


def read(ctx):
    return idle_share(ctx)
