"""The share of the FID window in which the device ran nothing, %."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.idle_share(ctx)
