"""The share of each batch's wall time spent in the port's featurize and
encode call (``runtime/features.batch_stream_features_device``), from the
benchmark's synced spans around that call and around the whole batch,
summed over the traced run's unprofiled batches."""

LAYER = "runtime/features"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(trace):
    s = trace.spans
    if trace.kind != "offline" or s.count("batch") == 0:
        return None
    return 100.0 * s.total("featurize") / s.total("batch")
