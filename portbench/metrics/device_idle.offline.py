"""The device's idle share of the profiled batch: 1 - the union of its
operations' intervals over the batch's wall time."""

from portbench.metrics._common import idle_percent

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return idle_percent(trace, "offline")
