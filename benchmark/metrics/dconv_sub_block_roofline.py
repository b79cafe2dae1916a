"""dconv_sub_block_roofline: the summed least time of the `dconv_sub_block` calls in the
traced stretch over their kernels' device time, in %."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "dconv_sub_block")
