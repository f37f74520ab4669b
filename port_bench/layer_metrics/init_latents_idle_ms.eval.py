"""Device-idle ms a batch of the scoring window inside the program's mcpc.init_latents span."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_ms(ctx, "eval", "mcpc.init_latents")
