"""The CVAE's host time (``stream.cvae`` spans: the condition, the prior
sample and the de-normalization) over the frame steps', in the profiled
batch; nothing where the configuration has no CVAE."""

from portbench.metrics._spans import step_share

LAYER = "models/cvae"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return step_share(trace, ("stream.cvae",))
