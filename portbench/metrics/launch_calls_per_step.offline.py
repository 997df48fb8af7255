"""Host launch calls a frame step: the CUDA runtime and driver launch
calls of the profiled batch (featurize, encode, match and every frame
step) over its frame steps.  Unlike the kernels a step, a CUDA graph's
replay counts once."""

from portbench.metrics._common import launch_calls_per

LAYER = "host dispatch"
UNIT = "calls/step"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return launch_calls_per(trace, "offline", "steps")
