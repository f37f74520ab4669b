"""The sample window's chain calls' least time over the chain kernel's device time, %."""

from port_bench.lib import readers


def read(ctx):
    return readers.chain_roofline(ctx, "sample")
