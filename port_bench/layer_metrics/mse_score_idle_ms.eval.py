"""Device-idle ms a batch inside the program's mcpc.mse_rec.score span: the decode, the threshold and the host read-back."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_ms(ctx, "eval", "mcpc.mse_rec.score")
