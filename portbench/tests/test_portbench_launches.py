"""The launch readers on slices made by hand: the kernels a unit of work
count what the device ran, the launch calls what the host called, so a
CUDA graph's replay (one call, many kernels) shows in the second alone."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.trace import Slice, Spans, Trace

READERS = harness.metric_readers()
KERNELS = [("gemm", 0, 10), ("elementwise", 12, 20), ("gemm", 30, 40),
           ("Memcpy DtoH (Device -> Pinned)", 40, 45)]
EAGER = [("cudaLaunchKernel", 0, 2), ("cuLaunchKernel", 10, 11),
         ("cudaLaunchKernelExC", 20, 22)]
GRAPH = [("cudaGraphLaunch", 0, 3)]


def trace(kind, calls, units):
    sl = Slice(wall_s=50e-9, ops=KERNELS, units=units, calls=calls)
    return Trace(kind=kind, mix={}, slice=sl, spans=Spans(torch.device("cpu")))


CASES = [("launch_calls_per_frame.live", "live", {"frames": 2},
          "launches_per_frame.live"),
         ("launch_calls_per_step.offline", "offline", {"steps": 3},
          "launches_per_step.offline")]


@pytest.mark.parametrize("name,kind,units,kernels", CASES)
def test_launch_calls_by_hand(name, kind, units, kernels):
    (n,) = units.values()
    assert READERS[name].read(trace(kind, EAGER, units)) == 3 / n
    # the same kernels from a graph: one call, the kernel count unmoved
    assert READERS[name].read(trace(kind, GRAPH, units)) == 1 / n
    assert READERS[kernels].read(trace(kind, GRAPH, units)) == 3 / n


@pytest.mark.parametrize("name,kind,units,kernels", CASES)
def test_no_launch_calls_read_nothing(name, kind, units, kernels):
    assert READERS[name].read(trace(kind, [], units)) is None   # a CPU run
    other = "offline" if kind == "live" else "live"
    assert READERS[name].read(trace(other, EAGER, units)) is None
    assert READERS[name].read(Trace(kind=kind, mix={}, slice=None,
                                    spans=Spans(torch.device("cpu")))) is None
