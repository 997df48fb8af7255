"""What a traced run records: synced host-clock spans around the calls the
benchmark makes into the port, and ``torch.profiler`` traces of a bounded
slice of the window.  Per-layer metrics read a :class:`Trace`."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

NAME_CHARS = 160
# host calls into the CUDA runtime or driver that launch device work; a
# CUDA graph's replay is one call however many kernels it holds.  The
# driver's two are how a kernel loaded as a module (Triton's) is launched.
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaGraphLaunch"))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Slice:
    """One profiled slice: its host wall time, its device operations
    (name, start ns, end ns), the units of work it held, and the host's
    launch calls (name, start ns, end ns) the profiler recorded."""

    wall_s: float
    ops: List[Tuple[str, int, int]]
    units: Dict[str, float] = field(default_factory=dict)
    calls: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def kernels(self) -> List[Tuple[str, int, int]]:
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))]

    def busy_s(self) -> float:
        """Seconds in which any device operation ran: the union of their
        intervals (an overlapped copy is counted once)."""
        busy, end = 0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        between operations summed by the operation that ended it."""
        by_op: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n[:NAME_CHARS]] += (e - s) * 1e-9
        gaps: Dict[str, float] = defaultdict(float)
        end = None
        for n, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                gaps["idle before " + n[:NAME_CHARS]] += (s - end) * 1e-9
            end = e if end is None else max(end, e)
        return {"device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])
                [:top],
                "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])
                [:top]}


def _events(prof):
    """(name, start ns, end ns) of every operation the profiler saw on a
    CUDA device, and of every host call in ``LAUNCH_CALLS`` (the CUDA
    activity's runtime and driver calls)."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if not on_device and e.name() not in LAUNCH_CALLS:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        (ops if on_device else calls).append(
            (e.name(), int(start), int(start + dur)))
    return ops, calls


def profile_slice(fn: Callable, dev: torch.device, **units):
    """Run ``fn`` under ``torch.profiler`` (device activity only, so the
    host pays little for it) and return (its result, the :class:`Slice`)."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    if dev.type != "cuda":      # no device to trace: the slice holds no ops
        t0 = time.perf_counter()
        out = fn()
        return out, Slice(wall_s=time.perf_counter() - t0, ops=[],
                          units=dict(units))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    ops, calls = _events(prof)
    return out, Slice(wall_s=wall, ops=ops, units=dict(units), calls=calls)


class Spans:
    """Host-clock spans, each closed after a device synchronize, summed by
    name; kept in memory for the metric readers."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def timed(self, name: str, fn: Callable):
        t0 = time.perf_counter()
        out = fn()
        sync(self.dev)
        self.seconds[name].append(time.perf_counter() - t0)
        return out

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))

    def count(self, name: str) -> int:
        return len(self.seconds.get(name, ()))


@dataclass
class Trace:
    """Everything a traced run hands the per-layer readers."""

    kind: str
    mix: Dict
    slice: Optional[Slice]
    spans: Spans
    counters: Dict[str, float] = field(default_factory=dict)
    facts: Dict = field(default_factory=dict)
