"""flash_mha_bwd_roofline: the summed least time of the `flash_mha_bwd` calls in the
traced stretch over their kernels' device time, in %."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "flash_mha_bwd")
