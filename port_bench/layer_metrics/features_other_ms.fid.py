"""Device ms a get_fid call of the kernels in the program's mcpc.fid.features span that no convolution launched: BatchNorm, relu, pools, concatenations, the resize, copies."""

from port_bench.lib import fid_readers


def read(ctx):
    return fid_readers.features_other_ms(ctx)
