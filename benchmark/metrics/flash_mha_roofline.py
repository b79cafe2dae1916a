"""flash_mha_roofline: the summed least time of the `flash_mha` calls in the
traced stretch over their kernels' device time, in %."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "flash_mha")
