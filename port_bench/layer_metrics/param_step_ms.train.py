"""Device ms a batch of the kernels one_batch launches besides the chain and the summing pass: the parameters' Adam step."""

from port_bench.lib import readers


def read(ctx):
    return readers.kernels_in_spans_ms(ctx, "train", "bench.one_batch", (readers.CHAIN_KERNEL, readers.SUM_KERNEL))
