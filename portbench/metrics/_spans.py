"""The port's own spans (``utils/profiling.span``) laid over the profiled
slice, for the ``program_span`` readers.

The port records spans only while a ``torch.profiler`` profile records,
and a traced run profiles one slice, so the spans in the port's store are
that slice's; each reader reads the store without emptying it.  A span's
start and end are host ns on the clock of the slice's device operations.
Every reader returns None where the slice holds no spans of the port (a
port that has none, the control, a CPU run), where the store dropped any,
or where the spans a reader needs are not there as often as the work the
slice did (a region captured in a CUDA graph records its spans once, at
capture)."""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.harness import PROGRAM

OUTSIDE = "outside the program"


def recorded():
    """(spans, dropped) from the port's store, or None where the port
    loaded in this process has no spans."""
    mod = sys.modules.get(f"{PROGRAM}.utils.profiling")
    if mod is None or not hasattr(mod, "spans"):
        return None
    return mod.spans(), mod.dropped_spans()


def window(sl) -> Tuple[int, int]:
    """The slice's interval in ns: its wall time, ending where its last
    device operation ends (the slice ends with a synchronize)."""
    end = max(e for _, _, e in sl.ops)
    return end - round(sl.wall_s * 1e9), end


def slice_spans(trace, kind) -> Optional[list]:
    """The port's spans that end after the profiled slice of a traced run
    of ``kind`` starts, or None.  (The first span opens microseconds after
    the slice starts, the last may open after its last device operation
    ends: a host that waits on work already done.)"""
    sl = trace.slice
    if trace.kind != kind or sl is None or not sl.ops:
        return None
    got = recorded()
    if got is None or got[1]:
        return None
    lo, _ = window(sl)
    spans = [s for s in got[0] if s.end_ns > lo]
    return spans or None


def dur(s) -> int:
    return s.end_ns - s.start_ns


def named(spans, name) -> list:
    return [s for s in spans if s.name == name]


def offline_steps(trace) -> Optional[list]:
    """The slice's spans where every runner call recorded a
    ``stream.step`` span for each frame after its first, else None."""
    spans = slice_spans(trace, "offline")
    if spans is None:
        return None
    runners = named(spans, "stream.runner")
    steps = named(spans, "stream.step")
    if not runners or len(steps) != sum(r.attrs["frames"] - 1
                                        for r in runners):
        return None
    return spans


def step_share(trace, parts) -> Optional[float]:
    """The host time of the ``parts`` spans inside the frame steps, in
    percent of the steps' own; None unless every step holds each part."""
    spans = offline_steps(trace)
    if spans is None:
        return None
    steps = {s.id: s for s in spans if s.name == "stream.step"}
    held: Dict[int, set] = {i: set() for i in steps}
    part_ns = 0
    for s in spans:
        if s.parent in steps and s.name in parts:
            held[s.parent].add(s.name)
            part_ns += dur(s)
    if any(h != set(parts) for h in held.values()):
        return None
    return 100.0 * part_ns / sum(dur(s) for s in steps.values())


def union(intervals) -> List[Tuple[int, int]]:
    """Sorted, disjoint intervals covering ``intervals``."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a, b) -> int:
    """The time two sorted, disjoint interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(sl, lo, hi) -> List[Tuple[int, int]]:
    """The parts of [lo, hi] in which no device operation runs."""
    out, t = [], lo
    for s, e in union((s, e) for _, s, e in sl.ops):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(spans) -> List[Tuple[int, int, str]]:
    """Time cut into pieces, each labelled with the innermost span open
    then (spans of one thread nest); time under no span has no piece."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s.start_ns, stack[-1][1]))
        t = s.start_ns
        stack.append((s.end_ns, s.name))
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_by_span(sl, spans) -> Dict[str, float]:
    """The slice's idle seconds by the innermost span open on the host
    meanwhile; idle under no span counts as ``OUTSIDE``."""
    lo, hi = window(sl)
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    out: Dict[str, float] = defaultdict(float)
    for s, e in idle_intervals(sl, lo, hi):
        covered = 0
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(pieces) and pieces[i][0] < e:
            a, b = max(s, pieces[i][0]), min(e, pieces[i][1])
            if b > a:
                out[pieces[i][2]] += (b - a) * 1e-9
                covered += b - a
            i += 1
        out[OUTSIDE] += (e - s - covered) * 1e-9
    return dict(out)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
