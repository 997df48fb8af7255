"""The port's serving spans (``utils/profiling.span``) on the CPU, at tiny
widths: nothing is recorded and nothing changes without a profiler; under
one the batch runner, the live session and the attention wrapper record
the span tree the benchmark's readers take apart, on the profiler's own
clock."""

import bisect
import inspect
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mocha_sigasia2023_torch.cli.characterize import derive_norm
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
from mocha_sigasia2023_torch.models.cvae import CVAEConfig, init_cvae
from mocha_sigasia2023_torch.models.generator import (GeneratorConfig,
                                                      init_generator)
from mocha_sigasia2023_torch.ops import attention as tattn
from mocha_sigasia2023_torch.ops import pose as tpose
from mocha_sigasia2023_torch.runtime import features as tfeat
from mocha_sigasia2023_torch.runtime import stream as tstream
from mocha_sigasia2023_torch.runtime.live import LiveCharacterizer
from mocha_sigasia2023_torch.utils import profiling

torch.set_num_threads(2)
CFG = GeneratorConfig(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
                      encoder_mlp_dim=32, decoder_dim=32, decoder_heads=2,
                      decoder_dim_head=16, decoder_mlp_dim=32)
STREAMS, FRAMES = 2, 16
PAD = CFG.nframes // 4    # frames a clip has beyond its windows
STEP_CHILDREN = ("stream.cvae", "stream.decode", "stream.roots", "stream.ik")


@pytest.fixture(scope="module")
def pipe():
    gen = init_generator(CFG, seed=1, device="cpu")
    cvae = init_cvae(CVAEConfig(output_seq=CFG.num_tokens, latent_dim=32,
                                feedforward_dim=32), seed=2, device="cpu")
    cha = make_mocha_bvh_data(T=110, seed=3)
    norm = derive_norm(cha, CFG.nframes, torch.device("cpu"))
    feats = tfeat.clip_stream_features_device(cha, gen, norm, device="cpu")
    consts = tstream.build_consts(
        norm, tfeat.compute_cnt_norm(feats["encoded"], feats["cnt"]), None,
        feats, device="cpu")
    parents = feats["bone_parents"]
    clips = [make_mocha_bvh_data(T=FRAMES + PAD, seed=10 + i)
             for i in range(STREAMS)]
    src = tfeat.clip_stream_features_device(clips[0], gen, norm,
                                            device="cpu")
    rows = [{k: src[k][i].numpy() for k in LiveCharacterizer.FEAT_KEYS}
            for i in range(4)]
    return dict(gen=gen, cvae=cvae, norm=norm, consts=consts,
                parents=parents, clips=clips, rows=rows)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def run_batch(pipe):
    runner = tstream.make_batch_runner(
        pipe["gen"], pipe["cvae"], pipe["consts"], pipe["parents"],
        compute_cm=False, root_dtype=torch.float64, device="cpu")
    frame0, xs = tfeat.batch_stream_features_device(
        pipe["clips"], pipe["gen"], pipe["norm"], window=CFG.nframes,
        emit_cnt=False, device="cpu")
    out = runner(frame0, xs, torch.Generator().manual_seed(5))
    return {k: v.numpy() for k, v in out.items()}


def run_live(pipe):
    live = LiveCharacterizer(pipe["gen"], pipe["cvae"], pipe["consts"],
                             pipe["parents"], device="cpu",
                             generator=torch.Generator().manual_seed(6))
    return [live.push_frame(r) for r in pipe["rows"]]


def profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, profiling.spans(), prof


def children(recorded, parent):
    return [s for s in recorded if s.parent == parent.id]


def test_no_profiler_records_nothing_and_changes_no_output(pipe):
    plain_batch, plain_live = run_batch(pipe), run_live(pipe)
    assert profiling.spans() == () and profiling.dropped_spans() == 0
    traced_batch, recorded, _ = profiled(run_batch, pipe)
    assert recorded
    traced_live, recorded, _ = profiled(run_live, pipe)
    assert recorded
    for k, v in plain_batch.items():
        np.testing.assert_array_equal(v, traced_batch[k], err_msg=k)
    for a, b in zip(plain_live, traced_live):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_batch_runner_records_its_span_tree(pipe):
    _, recorded, _ = profiled(run_batch, pipe)
    by_id = {s.id: s for s in recorded}
    for s in recorded:                    # each child inside its parent
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    feats, = [s for s in recorded if s.name == "features"]
    assert feats.attrs == {"streams": STREAMS, "frames": FRAMES + PAD}
    names = [s.name for s in children(recorded, feats)]
    assert names[0] == "features.featurize"
    assert set(names[1:]) == {"features.encode"}
    runner, = [s for s in recorded if s.name == "stream.runner"]
    assert runner.parent is None and runner.request is not None
    assert runner.attrs == {"streams": STREAMS, "frames": FRAMES}
    kids = sorted(children(recorded, runner), key=lambda s: s.start_ns)
    names = [s.name for s in kids]
    assert names == (["stream.match", "stream.init", "stream.match"]
                     + ["stream.step"] * (FRAMES - 1) + ["stream.finish"])
    assert kids[0].attrs == {"frames": 1, "streams": STREAMS}
    assert kids[2].attrs == {"frames": FRAMES - 1, "streams": STREAMS}
    steps = [s for s in kids if s.name == "stream.step"]
    assert [s.attrs["t"] for s in steps] == list(range(1, FRAMES))
    for st in steps:
        assert [c.name for c in sorted(children(recorded, st),
                                       key=lambda s: s.start_ns)] \
            == list(STEP_CHILDREN)
    decode, = [c for c in children(recorded, steps[0])
               if c.name == "stream.decode"]
    assert decode.attrs == {"decodes": 1}
    # one request id through the runner's tree
    tree, todo = set(), [runner.id]
    while todo:
        i = todo.pop()
        tree.add(i)
        todo += [s.id for s in recorded if s.parent == i]
    assert {by_id[i].request for i in tree} == {runner.request}
    assert len({s.id for s in recorded}) == len(recorded)


def test_the_runner_numbers_its_batches(pipe):
    runner = tstream.make_batch_runner(
        pipe["gen"], pipe["cvae"], pipe["consts"], pipe["parents"],
        device="cpu")
    frame0, xs = tfeat.batch_stream_features_device(
        pipe["clips"], pipe["gen"], pipe["norm"], device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            runner(frame0, xs, torch.Generator().manual_seed(5))
        runner.chunked({k: v.numpy() for k, v in frame0.items()},
                       {k: v.numpy() for k, v in xs.items()},
                       torch.Generator().manual_seed(5), tchunk=2)
    runners = [s for s in profiling.spans() if s.name == "stream.runner"]
    assert [s.request for s in runners] == [0, 1, 2]
    assert len([s for s in profiling.spans() if s.name == "stream.step"]) \
        == 3 * (FRAMES - 1)
    # compute_cm: both decodes in one stream.decode span
    decodes = [s for s in profiling.spans() if s.name == "stream.decode"]
    assert {s.attrs["decodes"] for s in decodes} == {2}


def test_a_live_session_records_push_dispatch_and_wait(pipe):
    _, recorded, _ = profiled(run_live, pipe)
    pushes = sorted((s for s in recorded if s.name == "live.push"),
                    key=lambda s: s.start_ns)
    assert [s.request for s in pushes] == list(range(len(pipe["rows"])))
    for i, push in enumerate(pushes):
        kids = sorted(children(recorded, push), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["live.dispatch", "live.wait"]
        dispatch = kids[0]
        inner = [k.name for k in sorted(children(recorded, dispatch),
                                        key=lambda s: s.start_ns)]
        assert inner == ["live.match",
                         "stream.init" if i == 0 else "stream.step"]
        if i:
            step, = [k for k in children(recorded, dispatch)
                     if k.name == "stream.step"]
            assert step.attrs == {"t": i, "route": "eager"}
        assert {k.request for k in kids} == {i}


def test_the_pose_spans_name_their_route(pipe):
    """Every step's stream.roots and stream.ik spans carry the route the
    pose math took: "eager" on the CPU, where the pose kernels' launch
    counters do not move (the batch runner and a live session)."""
    before = (tpose.pose_roots.launches, tpose.pose_ik.launches)
    _, batch, _ = profiled(run_batch, pipe)
    profiling.clear()
    _, live, _ = profiled(run_live, pipe)
    for recorded, steps in ((batch, FRAMES - 1),
                            (live, len(pipe["rows"]) - 1)):
        for name in ("stream.roots", "stream.ik"):
            got = [s for s in recorded if s.name == name]
            assert len(got) == steps
            assert all(s.attrs == {"route": "eager"} for s in got)
    assert (tpose.pose_roots.launches, tpose.pose_ik.launches) == before


def test_fused_attention_records_its_shapes():
    q = torch.randn(3, 2, 5, 16)
    k = v = torch.randn(3, 2, 7, 16)
    with profile(activities=[ProfilerActivity.CPU]):
        tattn.fused_attention(q, k, v, scale=0.25)
    s, = profiling.spans()
    assert s.name == "ops.attention" and s.parent is None
    assert s.attrs == {"B": 3, "H": 2, "N": 5, "M": 7, "d": 16,
                       "dtype": "float32", "route": "plain"}


def test_spans_lie_on_the_profilers_clock():
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            time.sleep(0.003)
            with profiling.span("probe", i=i):
                a @ a
    probes = profiling.spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(probes) == len(ops) == 5
    for s, e in zip(probes, sorted(ops, key=lambda e: e.start_ns())):
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns


def test_every_op_inside_a_span_lies_within_it(pipe):
    _, recorded, prof = profiled(run_batch, pipe)
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("aten::"))
    starts = [a for a, _ in ops]
    ends_so_far = np.maximum.accumulate([b for _, b in ops])
    inside = 0
    for s in recorded:     # no operation straddles a span's start or end
        lo = bisect.bisect_left(starts, s.start_ns)
        hi = bisect.bisect_right(starts, s.end_ns)
        assert lo == 0 or ends_so_far[lo - 1] <= s.start_ns, s.name
        assert all(b <= s.end_ns for _, b in ops[lo:hi]), s.name
        inside += hi - lo
    assert inside > len(ops)


def test_an_idle_span_allocates_nothing_and_touches_no_device():
    assert not profiling.recording()
    for _ in range(100):
        with profiling.span("warm", t=1):
            pass
    tracemalloc.start()
    try:
        for i in range(10000):
            with profiling.span("stream.step", t=i):
                pass
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1024
    assert profiling.spans() == ()
    # no span reads or waits on a device, or emits an annotation the
    # device trace would count
    src = inspect.getsource(profiling._On) + inspect.getsource(profiling.span)
    for word in ("synchronize", ".item(", ".cpu(", "record_function",
                 "nvtx", "cuda"):
        assert word not in src, word


def test_spans_emit_no_profiler_events(pipe):
    _, recorded, prof = profiled(run_batch, pipe)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {s.name for s in recorded}


def test_a_full_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped_spans() == 2
    profiling.clear()
    assert profiling.spans() == () and profiling.dropped_spans() == 0
