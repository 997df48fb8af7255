"""The port's featurize and encode host time (``features`` spans:
``runtime/features.batch_stream_features_device``) over that and the batch
runner's (``stream.runner``), in the profiled batch: the in-program twin
of ``featurize_share.offline``.  Host time, not synced: a span ends when
the host has queued its work."""

from portbench.metrics._spans import dur, named, slice_spans

LAYER = "runtime/features"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    spans = slice_spans(trace, "offline")
    if spans is None:
        return None
    features = sum(dur(s) for s in named(spans, "features"))
    runners = sum(dur(s) for s in named(spans, "stream.runner"))
    if not features or not runners:
        return None
    return 100.0 * features / (features + runners)
