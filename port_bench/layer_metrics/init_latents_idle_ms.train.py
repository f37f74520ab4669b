"""Device-idle ms a batch inside the program's mcpc.init_latents span: the latents' CPU draws, their copies and the forward products between sites."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_ms(ctx, "train", "mcpc.init_latents")
