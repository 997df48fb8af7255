"""Model FLOPs (``portbench/flops.py``: encoder, decoder, CVAE and matcher
products from the configuration's shapes) of the traced run's unprofiled
batches over their wall time, as a share of the H100's float32 peak of
67 TFLOP/s."""

from portbench.roofline import PEAK_FP32_FLOPS

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(trace):
    s = trace.spans
    if trace.kind != "offline" or s.count("batch") == 0:
        return None
    rate = trace.facts["batch_flops"] * s.count("batch") / s.total("batch")
    return 100.0 * rate / PEAK_FP32_FLOPS
