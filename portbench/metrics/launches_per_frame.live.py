"""Device kernels a ``push_frame``: the kernels of the profiled frames over
their count."""

from portbench.metrics._common import kernels_per

LAYER = "host dispatch"
UNIT = "kernels/frame"
SOURCE = "device_trace"
MOVES = "frame_latency_p95_ms"


def read(trace):
    return kernels_per(trace, "live", "frames")
