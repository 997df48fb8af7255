"""The runner call's wall time (matcher, then the frame-step loop; the
poses copied to the host) over its frame steps, one step serving every
stream of the batch: the benchmark's synced spans over the traced run's
unprofiled batches."""

LAYER = "runtime/stream"
UNIT = "ms/step"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(trace):
    s = trace.spans
    if trace.kind != "offline" or s.count("runner") == 0:
        return None
    steps = s.count("runner") * int(trace.mix["frames"])
    return 1e3 * s.total("runner") / steps
