"""bilstm_recurrence_roofline: the summed least time of the `bilstm_recurrence` calls in the
traced stretch over their kernels' device time, in %."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "bilstm_recurrence")
