"""The pose math's host time (``stream.roots``: the three root
integrations; ``stream.ik``: foot locking, two-bone IK and the blends)
over the frame steps', in the profiled batch."""

from portbench.metrics._spans import step_share

LAYER = "kinematics"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return step_share(trace, ("stream.roots", "stream.ik"))
