"""Device kernels a training step (forwards, losses, backward, AdamW, EMA):
the kernels of the profiled steps over their count."""

from portbench.metrics._common import kernels_per

LAYER = "host dispatch"
UNIT = "kernels/step"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(trace):
    return kernels_per(trace, "train", "steps")
