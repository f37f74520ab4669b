"""Ms a get_fid call in the program's mcpc.fid.stats and mcpc.fid.distance spans: the generated features' float64 moments and the distance."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.stats_ms(ctx)
