"""Device ms a chain of the kernels launched inside the program's mcpc.capture_rows span: the captured steps' recomputed scalar rows."""

from port_bench.lib import readers


def read(ctx):
    return readers.kernels_in_spans_ms(ctx, "sample", "mcpc.capture_rows", ())
