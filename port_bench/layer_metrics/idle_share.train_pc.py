"""The share of the train_pc window in which the device ran nothing, %."""

from port_bench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "train_pc")
