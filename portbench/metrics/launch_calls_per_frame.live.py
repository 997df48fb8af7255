"""Host launch calls a ``push_frame``: the CUDA runtime and driver launch
calls of the profiled frames over their count.  Unlike the kernels a
frame, a CUDA graph's replay counts once."""

from portbench.metrics._common import launch_calls_per

LAYER = "host dispatch"
UNIT = "calls/frame"
SOURCE = "device_trace"
MOVES = "frame_latency_p95_ms"


def read(trace):
    return launch_calls_per(trace, "live", "frames")
