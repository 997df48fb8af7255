"""The device's idle share of the profiled training steps."""

from portbench.metrics._common import idle_percent

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(trace):
    return idle_percent(trace, "train")
