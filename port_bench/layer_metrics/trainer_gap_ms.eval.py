"""Device-idle ms inside each PCTrainer.train_on_batch call of the scoring window."""

from port_bench.lib import readers


def read(ctx):
    return readers.span_gap_ms(ctx, "eval", "bench.train_on_batch")
