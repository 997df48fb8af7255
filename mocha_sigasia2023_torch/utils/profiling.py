"""Tracing and stage timing.

Counterpart of mocha_sigasia2023_tpu/utils/profiling.py:
:func:`device_trace` records a ``torch.profiler`` trace (host operators,
and the CUDA kernels and copies when a card is present) and writes it to
``log_dir`` as a Chrome / Perfetto trace; :class:`StageTimer` accumulates
the wall time of named pipeline stages, with the JAX class's
``report()`` and ``summary()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[profile]:
    """Profile the block; on leaving it write
    ``log_dir/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing).  Yields the profiler (``key_averages()`` etc.)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
