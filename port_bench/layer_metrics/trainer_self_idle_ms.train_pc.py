"""Device-idle ms a call inside the program's mcpc.train_on_batch span, less mcpc.init_latents and mcpc.chain, in the train_pc window."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_ms(ctx, "train_pc", "mcpc.train_on_batch", ("mcpc.init_latents", "mcpc.chain"))
