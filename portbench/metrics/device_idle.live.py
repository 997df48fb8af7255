"""The device's idle share of the profiled frames."""

from portbench.metrics._common import idle_percent

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_latency_p95_ms"


def read(trace):
    return idle_percent(trace, "live")
