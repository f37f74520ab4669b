"""The tanh warm chain with last-step gradients: its calls' least time at the f32-accurate peak over the chain kernel's device time, %."""

from port_bench.lib import readers


def read(ctx):
    return readers.chain_roofline(ctx, "train_pc")
