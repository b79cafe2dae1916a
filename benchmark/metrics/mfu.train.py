"""mfu.train: the model's operations done in the window over window x 495
TFLOP/s (the H100's dense TF32 peak), in %."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
