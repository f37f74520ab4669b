"""The share of the FID window's device-idle time outside every mcpc.* span of the program, %."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.unspanned_idle_share(ctx)
