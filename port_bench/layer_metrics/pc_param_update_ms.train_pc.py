"""Device ms a batch of the kernels launched inside the program's mcpc.trainer.param_update span: the trainer's Adam step on the parameters."""

from port_bench.lib import readers


def read(ctx):
    return readers.kernels_in_spans_ms(ctx, "train_pc", "mcpc.trainer.param_update", ())
