"""Device-idle us a call inside the program's mcpc.chain span, less mcpc.capture_rows: the wrapper's host work before and around the launch."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_us(ctx, "train", "mcpc.chain", ("mcpc.capture_rows",))
