"""Device-idle µs a batch inside the program's mcpc.trainer.warm_state span: the graft of the chain's Adam moments into the trainer's state."""

from port_bench.lib import program_spans


def read(ctx):
    return program_spans.self_idle_us(ctx, "train_pc", "mcpc.trainer.warm_state")
