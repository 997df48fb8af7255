"""Device kernels a frame step: the kernels of the profiled batch (featurize,
encode, match and every frame step) over its frame steps."""

from portbench.metrics._common import kernels_per

LAYER = "host dispatch"
UNIT = "kernels/step"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return kernels_per(trace, "offline", "steps")
