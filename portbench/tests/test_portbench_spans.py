"""The ``program_span`` readers' arithmetic on traces made by hand, their
silence where the slice holds no usable spans, and (on a card) the spans'
clock against the profiled slice's kernels."""

from __future__ import annotations

import time

import pytest
import torch

from mocha_sigasia2023_torch.utils import profiling
from portbench import harness
from portbench.metrics import _spans
from portbench.roofline import attention_bound_s
from portbench.trace import Slice, Spans, Trace, profile_slice

READERS = harness.metric_readers()
SPAN_READERS = sorted(n for n, r in READERS.items()
                      if r.SOURCE == "program_span")
OFFLINE = [n for n in SPAN_READERS if n.endswith(".offline")]
ATTN = (2, 4, 90, 90, 256, "float32")
KERNEL = "void (anonymous namespace)::attention_tf32x3_kernel<12>(...)"


def span_list(rows, request=0):
    """Spans from (id, parent, name, start, end, attrs) rows."""
    return [profiling.Span(i, p, n, s, e, request, a)
            for i, p, n, s, e, a in rows]


def offline_trace(captured=False, cvae=True):
    """A batch of 2 streams and 3 frames: featurize, then the runner with
    its match, init, two steps and finish, and device operations beside
    them (times in ns).  ``captured`` leaves out the second step's spans,
    as a step replayed from a CUDA graph would."""
    rows = [(0, None, "features", 100, 300, {"streams": 2, "frames": 18}),
            (1, 0, "features.featurize", 100, 150, {}),
            (2, 0, "features.encode", 150, 300, {"windows": 3}),
            (3, None, "stream.runner", 300, 1000,
             {"streams": 2, "frames": 3}),
            (4, 3, "stream.match", 300, 350, {"frames": 1, "streams": 2}),
            (5, 3, "stream.init", 350, 400, {}),
            (6, 3, "stream.match", 400, 450, {"frames": 2, "streams": 2}),
            (7, 3, "stream.step", 450, 700, {"t": 1}),
            (8, 7, "stream.cvae", 450, 500, {}),
            (9, 7, "stream.decode", 500, 600, {"decodes": 1}),
            (10, 9, "ops.attention", 510, 520, {}),
            (11, 7, "stream.roots", 600, 650, {}),
            (12, 7, "stream.ik", 650, 690, {}),
            (13, 3, "stream.step", 700, 950, {"t": 2}),
            (14, 13, "stream.cvae", 700, 760, {}),
            (15, 13, "stream.decode", 760, 850, {"decodes": 1}),
            (16, 15, "ops.attention", 770, 780, {}),
            (17, 13, "stream.roots", 850, 900, {}),
            (18, 13, "stream.ik", 900, 940, {}),
            (19, 3, "stream.finish", 950, 1000, {})]
    if not cvae:
        rows = [r for r in rows if r[2] != "stream.cvae"]
    rows = [r if r[2] != "ops.attention" else r[:5] + (dict(zip(
        ("B", "H", "N", "M", "d", "dtype"), ATTN), route="tuned"),)
        for r in rows]
    if captured:
        rows = [r for r in rows if r[0] < 13 or r[0] == 19]
    ops = [("elementwise", 120, 200), ("sgemm", 480, 620),
           (KERNEL, 620, 640), ("elementwise", 720, 730),
           (KERNEL, 730, 760), ("Memcpy DtoH (Device -> Pinned)", 1000, 1100)]
    sl = Slice(wall_s=1100e-9, ops=ops, units={"steps": 3, "frames": 6})
    trace = Trace(kind="offline", mix={"frames": 3}, slice=sl,
                  spans=Spans(torch.device("cpu")),
                  counters={"attention_launches": 2},
                  facts={"attention_calls": [ATTN + (2,)]})
    return trace, span_list(rows)


def live_trace():
    rows = [(0, None, "live.push", 0, 100, {}),
            (1, 0, "live.dispatch", 0, 60, {}),
            (2, 1, "live.match", 0, 10, {}),
            (3, 1, "stream.init", 10, 50, {}),
            (4, 0, "live.wait", 60, 95, {}),
            (5, None, "live.push", 100, 200, {}),
            (6, 5, "live.dispatch", 100, 150, {}),
            (7, 6, "live.match", 100, 110, {}),
            (8, 6, "stream.step", 110, 140, {"t": 1}),
            (9, 5, "live.wait", 150, 190, {})]
    # the last wait opens after the device has finished
    sl = Slice(wall_s=200e-9, ops=[("elementwise", 20, 140)],
               units={"frames": 2})
    trace = Trace(kind="live", mix={}, slice=sl,
                  spans=Spans(torch.device("cpu")))
    spans = span_list(rows[:5], 0) + span_list(rows[5:], 1)
    return trace, spans


def read(name, trace, spans, monkeypatch, dropped=0):
    monkeypatch.setattr(_spans, "recorded", lambda: (spans, dropped))
    return READERS[name].read(trace)


def test_eight_readers_read_the_ports_spans():
    assert SPAN_READERS == sorted([
        "featurize_span_share.offline", "step_span_ms.offline",
        "decode_share.offline", "cvae_share.offline", "pose_share.offline",
        "step_idle.offline", "attention_span_roofline.offline",
        "dispatch_span_ms.live"])


@pytest.mark.parametrize("name,want", [
    ("featurize_span_share.offline", 100 * 200 / 900),
    ("step_span_ms.offline", 250e-6),
    ("decode_share.offline", 100 * 190 / 500),
    ("cvae_share.offline", 100 * 110 / 500),
    ("pose_share.offline", 100 * 180 / 500),
    # steps [450, 950]; the device busy in [480, 640] and [720, 760]
    ("step_idle.offline", 100 * 300 / 500),
    ("attention_span_roofline.offline",
     100 * 2 * attention_bound_s(*ATTN) / 50e-9),
])
def test_offline_readers_by_hand(name, want, monkeypatch):
    trace, spans = offline_trace()
    assert read(name, trace, spans, monkeypatch) == pytest.approx(want,
                                                                  rel=1e-12)


def test_idle_by_innermost_span_by_hand(monkeypatch, capsys):
    trace, spans = offline_trace()
    # idle: [0, 120], [200, 480], [640, 720], [760, 1000]
    want = {"outside the program": 100, "features.featurize": 20,
            "features.encode": 100, "stream.match": 100, "stream.init": 50,
            "stream.cvae": 50, "stream.roots": 60, "stream.ik": 80,
            "stream.step": 20, "stream.decode": 80, "ops.attention": 10,
            "stream.finish": 50}
    got = _spans.idle_by_span(trace.slice, spans)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-9, rel=1e-9), k
    read("step_idle.offline", trace, spans, monkeypatch)
    line, = capsys.readouterr().err.splitlines()
    assert line.startswith("[portbench] step_idle.offline:")
    assert "outside the program" in line and "; 2 steps" in line


def test_union_and_overlap():
    u = _spans.union([(5, 9), (0, 2), (1, 3), (8, 12)])
    assert u == [(0, 3), (5, 12)]
    assert _spans.overlap_ns(u, [(2, 6), (11, 20)]) == 1 + 1 + 1


def test_the_live_reader_by_hand(monkeypatch, capsys):
    trace, spans = live_trace()
    got = read("dispatch_span_ms.live", trace, spans, monkeypatch)
    assert got == pytest.approx(55e-6, rel=1e-12)
    assert "mean live.wait 3.75e-05 ms" in capsys.readouterr().err


def test_the_span_roofline_equals_the_shape_roofline(monkeypatch):
    trace, spans = offline_trace()
    mine = read("attention_span_roofline.offline", trace, spans, monkeypatch)
    theirs = READERS["attention_roofline.offline"].read(trace)
    assert mine == pytest.approx(theirs, rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_without_usable_spans(name, monkeypatch):
    trace, spans = (live_trace() if name.endswith(".live")
                    else offline_trace())
    assert read(name, trace, spans, monkeypatch) is not None
    assert read(name, trace, [], monkeypatch) is None          # no spans
    assert read(name, trace, spans, monkeypatch, dropped=1) is None
    monkeypatch.setattr(_spans, "recorded", lambda: None)      # a port
    assert READERS[name].read(trace) is None                   # without
    cpu = Trace(kind=trace.kind, mix=trace.mix,                # a CPU run
                slice=Slice(wall_s=1.0, ops=[], units=trace.slice.units),
                spans=trace.spans)
    assert read(name, cpu, spans, monkeypatch) is None
    other = live_trace() if name.endswith(".offline") else offline_trace()
    assert read(name, other[0], other[1], monkeypatch) is None  # kind


@pytest.mark.parametrize("name", [n for n in OFFLINE
                                  if n != "featurize_span_share.offline"])
def test_nothing_where_steps_fired_only_at_capture(name, monkeypatch):
    trace, spans = offline_trace(captured=True)
    assert read(name, trace, spans, monkeypatch) is None


def test_cvae_share_is_silent_without_a_cvae(monkeypatch):
    trace, spans = offline_trace(cvae=False)
    assert read("cvae_share.offline", trace, spans, monkeypatch) is None
    assert read("decode_share.offline", trace, spans,
                monkeypatch) is not None


def test_spans_from_before_the_slice_are_not_read(monkeypatch):
    trace, spans = offline_trace()
    stale = [s._replace(id=s.id + 100, parent=None if s.parent is None
                        else s.parent + 100, start_ns=s.start_ns - 10 ** 9,
                        end_ns=s.end_ns - 10 ** 9) for s in spans]
    for name in OFFLINE:
        assert read(name, trace, stale + spans, monkeypatch) == \
            read(name, trace, spans, monkeypatch), name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the spans' clock against kernels needs a CUDA device; "
                    "this host has none")
    return torch.device("cuda", 0)


def test_kernels_start_after_the_span_that_launched_them(card):
    x = torch.zeros(1 << 20, device=card)
    x.add_(1)
    profiling.clear()

    def probes():
        for i in range(8):
            torch.cuda.synchronize(card)
            time.sleep(0.002)
            with profiling.span("probe", i=i):
                x.add_(1)

    try:
        _, sl = profile_slice(probes, card)
        recorded = [s for s in profiling.spans() if s.name == "probe"]
    finally:
        profiling.clear()
    kernels = sorted(sl.kernels, key=lambda k: k[1])
    assert len(recorded) == len(kernels) == 8
    lo, hi = _spans.window(sl)
    for i, (s, k) in enumerate(zip(recorded, kernels)):
        assert lo < s.start_ns < hi
        assert s.start_ns <= k[1] < s.start_ns + 50_000_000, (i, s, k)
        if i + 1 < len(recorded):
            assert k[1] < recorded[i + 1].start_ns
