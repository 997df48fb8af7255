"""The device's idle share of the frame steps: the part of the union of
the profiled batch's ``stream.step`` host intervals in which no device
operation runs.  Also logs the whole slice's idle seconds by the innermost
port span open on the host meanwhile (idle under no span is "outside the
program": the benchmark's loop and its copies to the host)."""

from portbench.metrics._spans import (idle_by_span, log, named,
                                      offline_steps, overlap_ns, union)

LAYER = "device, by host span"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    spans = offline_steps(trace)
    if spans is None:
        return None
    sl = trace.slice
    steps = union((s.start_ns, s.end_ns) for s in named(spans, "stream.step"))
    total = sum(e - s for s, e in steps)
    table = idle_by_span(sl, spans)
    log("step_idle.offline: the slice's idle seconds by the innermost "
        "port span open on the host: " + ", ".join(
            f"{n} {s!r}" for n, s in sorted(table.items(),
                                            key=lambda kv: -kv[1]))
        + f" (idle {sum(table.values())!r} s of {sl.wall_s!r} s; "
        f"{len(named(spans, 'stream.step'))} steps, {total * 1e-9!r} s)")
    busy = union((s, e) for _, s, e in sl.ops)
    return 100.0 * (total - overlap_ns(steps, busy)) / total
