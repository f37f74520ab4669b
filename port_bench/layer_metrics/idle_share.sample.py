"""The share of the sample window in which the device ran nothing, %."""

from port_bench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "sample")
