"""The mean host duration of a frame step (``stream.step`` spans of
``runtime/stream.make_stream_step``) in the profiled batch: the host's
time to queue one step for every stream, with no synchronize."""

from portbench.metrics._spans import dur, named, offline_steps

LAYER = "runtime/stream"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    spans = offline_steps(trace)
    if spans is None:
        return None
    steps = named(spans, "stream.step")
    return 1e-6 * sum(dur(s) for s in steps) / len(steps)
