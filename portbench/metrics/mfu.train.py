"""Model FLOPs of a training step (``portbench/flops.py``: the six
generator forwards of the loss and the backward) times the traced run's
unprofiled steps over their wall time, as a share of the H100's float32
peak of 67 TFLOP/s."""

from portbench.roofline import PEAK_FP32_FLOPS

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s"


def read(trace):
    s = trace.spans
    if trace.kind != "train" or s.count("steps") == 0:
        return None
    steps = trace.facts["window_steps"]
    rate = trace.facts["step_flops"] * steps / s.total("steps")
    return 100.0 * rate / PEAK_FP32_FLOPS
