"""The FID window's InceptionV3 forwards' least time over the device time of the kernels launched in the program's mcpc.fid.features span, %."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.features_roofline(ctx)
