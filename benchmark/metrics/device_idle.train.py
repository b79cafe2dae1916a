"""device_idle.train: the share of the traced stretch with no kernel, copy
or fill running on the device, in %."""

from benchmark.harness.readers import device_idle


def read(run):
    return device_idle(run)
