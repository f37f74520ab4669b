"""The share of the train window's device-idle time outside every mcpc.* span of the program, %."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.unspanned_idle_share(ctx, "train")
