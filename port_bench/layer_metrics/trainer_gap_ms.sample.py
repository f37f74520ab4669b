"""Device-idle ms inside each PCTrainer.train_on_batch call of the sampling window."""

from port_bench.lib import readers


def read(ctx):
    return readers.span_gap_ms(ctx, "sample", "bench.train_on_batch")
