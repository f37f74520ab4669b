"""Device us of a summing pass in the training window."""

from port_bench.lib import readers


def read(ctx):
    return readers.mean_kernel_us(ctx, "train", readers.SUM_KERNEL)
