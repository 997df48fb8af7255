"""Arithmetic the readers share."""

from __future__ import annotations


def idle_percent(trace, kind):
    """The device's idle share of the profiled slice, in percent: 1 - the
    union of its operations' intervals over the slice's wall time."""
    sl = trace.slice
    if trace.kind != kind or sl is None or not sl.ops or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)


def kernels_per(trace, kind, unit):
    """Device kernels of the profiled slice per ``unit`` of work."""
    sl = trace.slice
    if trace.kind != kind or sl is None or not sl.kernels:
        return None
    return len(sl.kernels) / sl.units[unit]


def launch_calls_per(trace, kind, unit):
    """The host's launch calls in the profiled slice (a CUDA graph's replay
    is one) per ``unit`` of work."""
    sl = trace.slice
    if trace.kind != kind or sl is None or not sl.calls:
        return None
    return len(sl.calls) / sl.units[unit]
