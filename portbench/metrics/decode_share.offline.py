"""The generator decodes' host time (``stream.decode`` spans) over the
frame steps' (``stream.step``), in the profiled batch."""

from portbench.metrics._spans import step_share

LAYER = "models/generator"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return step_share(trace, ("stream.decode",))
