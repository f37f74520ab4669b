"""Blocking CUDA runtime calls that start inside the program's mcpc.* spans, a get_fid call (over the mcpc.fid.features spans)."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.host_waits(ctx)
