"""The FID window's model FLOPs (InceptionV3 convolutions and the ancestral pass) over its time at the 165 TFLOP/s f32-accurate peak, %."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.mfu(ctx)
