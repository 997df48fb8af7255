"""The attention kernels' share of their roofline in the profiled batch:
``portbench/roofline.py``'s bound, summed over the batch's attention calls
from their shapes (the encoder's chunks and one decode a frame, from the
configuration), over the device time of the kernels that
``attention_kernels.json`` names.  The calls are counted three ways, which
must agree: kernels in the trace, ``fused_attention``'s launch counters,
and the count from the configuration's shapes; where they do not, nothing
is reported."""

import json
import os
import sys

from portbench.roofline import attention_bound_s

LAYER = "ops/attention kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "attention_kernels.json")) as _f:
    NAMES = tuple(json.load(_f)["substrings"])


def read(trace):
    sl = trace.slice
    if trace.kind != "offline" or sl is None or not sl.kernels:
        return None
    calls = [k for k in sl.kernels if any(n in k[0] for n in NAMES)]
    shapes = trace.facts["attention_calls"]
    expected = sum(s[-1] for s in shapes)
    counted = trace.counters.get("attention_launches")
    if len(calls) != expected or counted != expected:
        print(f"[portbench] attention calls: {len(calls)} kernels in the "
              f"trace, {counted} launches counted, {expected} from the "
              "shapes; attention_roofline left out", file=sys.stderr)
        return None
    bound = sum(attention_bound_s(*s[:6]) * s[6] for s in shapes)
    busy = sum(e - s for _, s, e in calls) * 1e-9
    return 100.0 * bound / busy
