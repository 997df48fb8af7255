"""Tracing and stage timing.

Counterpart of mocha_sigasia2023_tpu/utils/profiling.py:
:func:`device_trace` records a ``torch.profiler`` trace (host operators,
and the CUDA kernels and copies when a card is present) and writes it to
``log_dir`` as a Chrome / Perfetto trace; :class:`StageTimer` accumulates
the wall time of named pipeline stages, with the JAX class's
``report()`` and ``summary()``.

:func:`span` marks a layer of the serving path on the host.  A span
records only while a ``torch.profiler`` profile is recording (the rule of
``record_function``); otherwise it costs one check of a flag.  A recorded
:class:`Span` holds its id, its parent's, its name, its host start and
end in integer ns on the profiler's clock (Unix-epoch ns, the clock of
its events' ``start_ns()``), the request it serves (inherited from the
enclosing span unless given) and its attributes.  Spans are kept in a
bounded store in memory (:func:`spans`, :func:`dropped_spans`,
:func:`clear`).  A span never launches, synchronizes or reads a device
value, and emits no ``record_function`` or NVTX range, so a device trace
holds the same operations with spans as without.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

MAX_SPANS = 1 << 18     # spans the store keeps; later ones are counted
SPAN_TID = 2 ** 31 - 1  # the spans' thread in a written trace


class Span(NamedTuple):
    """One recorded span; start and end in host ns on the profiler's
    clock."""

    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    request: Optional[int]
    attrs: Dict[str, Any]


def _epoch_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the closest of a few
    readings: spans are stamped on the monotonic clock and moved to the
    epoch clock the profiler's events use."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_OFFSET_NS = _epoch_offset_ns()
_ids = itertools.count()
_open = threading.local()      # .stack: this thread's open spans
_store: list = []
_dropped = 0


def now_ns() -> int:
    """The spans' clock: Unix-epoch ns."""
    return time.perf_counter_ns() + _OFFSET_NS


class _Off:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _On:
    __slots__ = ("name", "request", "attrs", "id", "parent", "start")

    def __init__(self, name, request, attrs):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        if self.request is None and up is not None:
            self.request = up.request
        stack.append(self)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        global _dropped
        _open.stack.pop()
        if len(_store) < MAX_SPANS:
            _store.append(Span(self.id, self.parent, self.name,
                               self.start + _OFFSET_NS, end + _OFFSET_NS,
                               self.request, self.attrs))
        else:
            _dropped += 1
        return None


def recording() -> bool:
    """Whether spans record now (a ``torch.profiler`` profile records)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, request: Optional[int] = None, **attrs):
    """Context manager marking one layer of the serving path: recorded
    while a ``torch.profiler`` profile records, else a no-op.
    ``request`` names the request the span serves (child spans inherit
    it); ``attrs`` are its units of work."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, request, attrs)


def spans() -> Tuple[Span, ...]:
    """The recorded spans, in the order they closed."""
    return tuple(_store)


def dropped_spans() -> int:
    """Spans the full store did not keep since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the store."""
    global _dropped
    _store.clear()
    _dropped = 0


def _write_spans(path: str, recorded) -> None:
    """Add ``recorded`` to the Chrome trace at ``path`` as complete events
    on a thread of their own, on the trace's timeline."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID, "args": {"name": "port spans"}})
    for s in recorded:
        events.append({"ph": "X", "cat": "port_span", "name": s.name,
                       "pid": pid, "tid": SPAN_TID,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, id=s.id, parent=s.parent,
                                    request=s.request)})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[profile]:
    """Profile the block; on leaving it write
    ``log_dir/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing), with the spans the block recorded on a "port spans"
    thread above the kernels.  Yields the profiler (``key_averages()``
    etc.)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = now_ns()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _write_spans(path, [s for s in spans() if s.start_ns >= t0])


def _cuda_devices(tree, found):
    if torch.is_tensor(tree):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages.

    With ``block=True`` a stage waits for the devices of the tensors kept
    through its ``keep`` (every CUDA device they lie on is synchronized),
    so that a stage of queued kernels measures their completion, not
    their dispatch; tensors on the CPU need no wait.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None, block: bool = True):
        t0 = time.perf_counter()
        holder = {}

        def keep(x):
            holder["out"] = x
            return x

        try:
            yield keep
        finally:
            if block and "out" in holder:
                for dev in _cuda_devices(holder["out"], set()):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(
                f"{name:32s} total {tot * 1e3:9.2f} ms  "
                f"calls {n:5d}  mean {tot / n * 1e3:8.3f} ms")
        return "\n".join(lines)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_ms": self.totals[k] / self.counts[k] * 1e3}
            for k in self.totals
        }
