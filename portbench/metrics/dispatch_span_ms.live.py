"""The mean host duration of queuing one live frame (``live.dispatch``
spans of ``runtime/live.LiveCharacterizer``: the upload, the match and
the stream step queued, the pose's copy queued) over the profiled frames.
Also logs the mean wait for the pose (``live.wait``)."""

from portbench.metrics._spans import dur, log, named, slice_spans

LAYER = "runtime/live"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_latency_p95_ms"


def read(trace):
    spans = slice_spans(trace, "live")
    if spans is None:
        return None
    frames = int(trace.slice.units["frames"])
    pushes = named(spans, "live.push")
    dispatches = named(spans, "live.dispatch")
    waits = named(spans, "live.wait")
    if not (len(pushes) == len(dispatches) == len(waits) == frames):
        log(f"live spans: {len(pushes)} pushes, {len(dispatches)} "
            f"dispatches, {len(waits)} waits for {frames} frames; "
            "dispatch_span_ms left out")
        return None
    log(f"dispatch_span_ms.live: mean live.wait "
        f"{1e-6 * sum(dur(s) for s in waits) / frames!r} ms, "
        f"mean live.push {1e-6 * sum(dur(s) for s in pushes) / frames!r} "
        f"ms over {frames} frames")
    return 1e-6 * sum(dur(s) for s in dispatches) / frames
