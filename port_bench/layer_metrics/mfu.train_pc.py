"""The train_pc window's model FLOPs over its time at the 165 TFLOP/s f32-accurate peak, %."""

from port_bench.lib import readers


def read(ctx):
    return readers.mfu(ctx, "train_pc")
