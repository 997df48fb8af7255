"""The attention kernels' share of their roofline in the profiled batch,
from the calls the port recorded: ``portbench/roofline.py``'s bound summed
over the shapes and dtypes of the ``ops.attention`` spans
(``ops/attention.fused_attention``), over the device time of the kernels
that ``attention_kernels.json`` names.  Reported only where there are as
many spans as such kernels; nothing comes from the configuration or the
featurize chunk."""

import json
import os

from portbench.metrics._spans import log, named, slice_spans
from portbench.roofline import attention_bound_s

LAYER = "ops/attention kernels"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "attention_kernels.json")) as _f:
    NAMES = tuple(json.load(_f)["substrings"])


def read(trace):
    spans = slice_spans(trace, "offline")
    if spans is None:
        return None
    calls = named(spans, "ops.attention")
    kernels = [k for k in trace.slice.kernels
               if any(n in k[0] for n in NAMES)]
    if not kernels or len(calls) != len(kernels):
        log(f"attention spans: {len(calls)} calls recorded, "
            f"{len(kernels)} kernels in the trace; "
            "attention_span_roofline left out")
        return None
    bound = sum(attention_bound_s(*(c.attrs[k] for k in
                                    ("B", "H", "N", "M", "d", "dtype")))
                for c in calls)
    busy = sum(e - s for _, s, e in kernels) * 1e-9
    return 100.0 * bound / busy
