"""Blocking CUDA runtime calls that start inside the program's mcpc.* spans, a batch (over the mcpc.train_on_batch spans)."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.host_waits(ctx, "train_pc", "mcpc.train_on_batch")
