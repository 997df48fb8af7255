"""The frame step as a CUDA graph (``runtime/step_graph``).

On the CPU: every step of the batch runner and of a live session, and
every bootstrap frame, takes the eager route, says so on its
``stream.step`` span and moves none of the graph counters; the packing of
a frame's tensors into rows (``Rows``) and the carry's copies
(``clone_tree``, ``copy_tree``) keep every value, dtype and shape.

On a card (``card`` tests, skipped on a host without one): the graph
route held bit for bit (max |d| 0) to the eager route, each forced by
:func:`step_graph.route` in turn, in a runner at S = 64 streams with
float64 roots over two batches with fresh seeded generators (each
generator's state after its batch as the eager route leaves it), a
30-character grouped runner at S = 256 without the CVAE, and a live
session over 300 frames with a ``reset()`` in the middle; the launch
counters read the same on both routes.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_step_graph.py`` (the
suite's conftest imports JAX, which that machine lacks).
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mocha_sigasia2023_torch.cli.characterize import (  # noqa: E402
    derive_norm)
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.kinematics.inertial import (  # noqa: E402
    ContactState)
from mocha_sigasia2023_torch.models.cvae import (  # noqa: E402
    CVAEConfig, init_cvae)
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, init_generator)
from mocha_sigasia2023_torch.ops import attention, pose  # noqa: E402
from mocha_sigasia2023_torch.runtime import (  # noqa: E402
    features, step_graph, stream)
from mocha_sigasia2023_torch.runtime.live import (  # noqa: E402
    LiveCharacterizer)
from mocha_sigasia2023_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
# tiny widths; head dims of 64 keep every attention on the tuned kernels
CFG = GeneratorConfig(encoder_dim=64, encoder_heads=2, encoder_dim_head=64,
                      encoder_mlp_dim=64, decoder_dim=64, decoder_heads=2,
                      decoder_dim_head=64, decoder_mlp_dim=64)
PAD = CFG.nframes // 4     # frames a clip has beyond its windows
MIN_FRAMES = 16            # featurize's filters need a clip of 16 + PAD


def _models(dev):
    gen = init_generator(CFG, seed=1, device=dev)
    cvae = init_cvae(CVAEConfig(output_seq=CFG.num_tokens, latent_dim=64,
                                feedforward_dim=32), seed=2, device=dev)
    return gen, cvae


def _character(gen, dev, seed=3, frames=110):
    """(norm, consts, parents) of one synthetic character."""
    cha = make_mocha_bvh_data(T=frames, seed=seed)
    norm = derive_norm(cha, CFG.nframes, dev)
    feats = features.clip_stream_features_device(cha, gen, norm, device=dev)
    consts = stream.build_consts(
        norm, features.compute_cnt_norm(feats["encoded"], feats["cnt"]),
        None, feats, device=dev)
    return norm, consts, feats["bone_parents"]


def _batch(gen, norm, dev, streams, frames, seed):
    clips = [make_mocha_bvh_data(T=frames + PAD, seed=seed + i)
             for i in range(streams)]
    return features.batch_stream_features_device(
        clips, gen, norm, window=CFG.nframes, emit_cnt=False, device=dev)


def _live_rows(gen, norm, dev, frames, seed=40):
    src = features.clip_stream_features_device(
        make_mocha_bvh_data(T=max(frames, MIN_FRAMES) + PAD, seed=seed),
        gen, norm, device=dev)
    return [{k: src[k][i].cpu().numpy()
             for k in LiveCharacterizer.FEAT_KEYS} for i in range(frames)]


def _counters():
    f = attention.fused_attention
    return {"launches": f.launches, "launches_bf16": f.launches_bf16,
            "launches_general": f.launches_general,
            "pose_roots": pose.pose_roots.launches,
            "pose_ik": pose.pose_ik.launches,
            "pose_eager": pose.eager_steps}


def _graph_counters():
    return (step_graph.captures, step_graph.replays, step_graph.eager_steps)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_pipe():
    torch.set_num_threads(2)
    gen, cvae = _models(CPU)
    norm, consts, parents = _character(gen, CPU)
    return dict(gen=gen, cvae=cvae, norm=norm, consts=consts,
                parents=parents)


def test_cpu_route_is_eager_and_counts_nothing():
    before = _graph_counters()
    assert step_graph.route(torch.zeros(3)) == "eager"
    assert step_graph.route(torch.zeros(3), steps=7) == "eager"
    with torch.no_grad():
        assert step_graph.route(torch.zeros(3, dtype=torch.float64)) \
            == "eager"
    assert _graph_counters() == before


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_cpu_runner_steps_are_eager_and_say_so(cpu_pipe, chunked):
    p = cpu_pipe
    frames = MIN_FRAMES
    runner = stream.make_batch_runner(
        p["gen"], p["cvae"], p["consts"], p["parents"], compute_cm=False,
        root_dtype=torch.float64, device=CPU)
    frame0, xs = _batch(p["gen"], p["norm"], CPU, 2, frames, seed=10)
    before, launches = _graph_counters(), _counters()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        if chunked:
            out = runner.chunked({k: v.numpy() for k, v in frame0.items()},
                                 {k: v.numpy() for k, v in xs.items()},
                                 torch.Generator().manual_seed(5), tchunk=4)
        else:
            out = runner(frame0, xs, torch.Generator().manual_seed(5))
    steps = [s for s in profiling.spans() if s.name == "stream.step"]
    inits = [s for s in profiling.spans() if s.name == "stream.init"]
    profiling.clear()
    assert len(inits) == 1
    assert [s.attrs for s in steps] == [{"t": t, "route": "eager"}
                                        for t in range(1, frames)]
    assert _graph_counters() == before and _counters() == launches
    for k, v in out.items():
        assert v.shape[:2] == (frames, 2), k


def test_cpu_chunked_runner_equals_the_whole_one(cpu_pipe):
    """The outputs come back as blocks of frames concatenated in order,
    whatever the chunking."""
    p = cpu_pipe
    runner = stream.make_batch_runner(
        p["gen"], p["cvae"], p["consts"], p["parents"], compute_cm=False,
        root_dtype=torch.float64, device=CPU)
    frame0, xs = _batch(p["gen"], p["norm"], CPU, 2, MIN_FRAMES, seed=20)
    whole = runner(frame0, xs, torch.Generator().manual_seed(9))
    parts = runner.chunked({k: v.numpy() for k, v in frame0.items()},
                           {k: v.numpy() for k, v in xs.items()},
                           torch.Generator().manual_seed(9), tchunk=6)
    assert set(whole) == set(parts)
    for k in whole:
        assert whole[k].dtype == parts[k].dtype, k
        assert torch.equal(whole[k], parts[k]), k


def test_cpu_live_frames_are_eager_and_say_so(cpu_pipe):
    """The bootstrap frame (``stream.init``, after a reset too) and every
    step of a live session take the eager route on the CPU."""
    p = cpu_pipe
    live = LiveCharacterizer(p["gen"], p["cvae"], p["consts"], p["parents"],
                             device=CPU,
                             generator=torch.Generator().manual_seed(6))
    rows = _live_rows(p["gen"], p["norm"], CPU, 6)
    before, launches = _graph_counters(), _counters()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for r in rows[:3]:
            live.push_frame(r)
        live.reset()
        for r in rows[3:]:
            live.push_frame(r)
    recorded = profiling.spans()
    profiling.clear()
    assert len([s for s in recorded if s.name == "stream.init"]) == 2
    steps = sorted((s for s in recorded if s.name == "stream.step"),
                   key=lambda s: s.start_ns)
    assert [s.attrs for s in steps] == [{"t": t, "route": "eager"}
                                        for t in (1, 2, 4, 5)]
    assert _graph_counters() == before and _counters() == launches
    assert live._graph is None


def test_rows_pack_gather_scatter_and_frames():
    """Each tensor keeps its values, dtype and shape through the packed
    rows; ``align`` starts each at a multiple of that many elements."""
    g = torch.Generator().manual_seed(0)
    n, S = 5, 3
    frames = {"a": torch.randn(n, S, 4, 3, generator=g),
              "b": torch.randn(n, S, generator=g),
              "i": torch.randint(0, 99, (n, S), generator=g),
              "c": torch.randn(n, S, 2, generator=g).double()}
    rows = step_graph.Rows({k: v[0] for k, v in frames.items()}, 7,
                           align=16)
    assert set(rows.bufs) == {torch.float32, torch.int64, torch.float64}
    assert all(o % 16 == 0 for _, o, _ in rows.at.values())
    rows.load(frames)
    for t in range(n):
        x = rows.gather(torch.tensor([t]))
        for k, v in frames.items():
            assert x[k].dtype == v.dtype and torch.equal(x[k], v[t]), (t, k)
    out = step_graph.Rows({k: v[0] for k, v in frames.items()}, n)
    for t in reversed(range(n)):
        out.scatter(torch.tensor([t]), {k: v[t] for k, v in frames.items()})
    got = out.frames(1, 4)
    for k, v in frames.items():
        assert got[k].is_contiguous() and torch.equal(got[k], v[1:4]), k


def test_clone_and_copy_tree_keep_a_carry():
    """A StreamCarry (with its nested contact state, three dtypes) cloned
    into buffers of its own, then written over by another carry; a leaf
    copied onto itself is left alone."""
    g = torch.Generator().manual_seed(1)

    def carry(scale):
        f = lambda *s: torch.randn(*s, generator=g) * scale  # noqa: E731
        d = lambda *s: f(*s).double()  # noqa: E731
        cs = ContactState(torch.rand(2, 2, generator=g) > 0.5,
                          torch.rand(2, 2, generator=g) > 0.5,
                          *(d(2, 2, 3) for _ in range(6)))
        return stream.StreamCarry(d(2, 3), d(2, 4), d(2, 3), f(2, 5, 3),
                                  d(2, 4), f(2, 5, 3), d(2, 3), d(2, 4),
                                  f(2, 4, 8), cs)

    a, b = carry(1.0), carry(2.0)
    c = step_graph.clone_tree(a)
    assert type(c) is stream.StreamCarry
    assert type(c.contacts) is ContactState
    for x, y in zip(step_graph.leaves(a), step_graph.leaves(c)):
        assert x is not y and x.dtype == y.dtype and torch.equal(x, y)
    step_graph.copy_tree(c, b)
    for x, y in zip(step_graph.leaves(b), step_graph.leaves(c)):
        assert torch.equal(x, y)
    step_graph.copy_tree(c, c._replace(src_pos0=a.src_pos0))
    assert torch.equal(c.src_pos0, a.src_pos0)
    assert torch.equal(c.trans_pos0, b.trans_pos0)


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs run on a CUDA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def eager_route(monkeypatch):
    """A context in which every step takes the eager route."""
    import contextlib

    @contextlib.contextmanager
    def forced():
        with monkeypatch.context() as m:
            m.setattr(step_graph, "route",
                      lambda like, steps=1: "eager")
            yield
    return forced


def _equal(a, b, where):
    assert set(a) == set(b), where
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        d = (a[k].double() - b[k].double()).abs().max().item() \
            if a[k].is_floating_point() else int((a[k] != b[k]).sum())
        assert d == 0, (where, k, d)


def _run_batches(runner, batches, seeds, dev, **kw):
    """Each batch with a fresh generator: (outputs, the generator's state
    after it, the launch counters it moved)."""
    got = []
    for (frame0, xs), seed in zip(batches, seeds):
        g = torch.Generator(device=dev).manual_seed(seed)
        before = _counters()
        out = runner(frame0, xs, g, **kw)
        torch.cuda.synchronize()
        after = _counters()
        got.append(({k: v.clone() for k, v in out.items()}, g.get_state(),
                    {k: after[k] - before[k] for k in after}))
    return got


@pytest.mark.card
def test_card_graph_runner_equals_eager_bit_for_bit(card, eager_route):
    """S = 64, float64 roots, the CVAE's noise: two batches, each with a
    fresh seeded generator, by the graph route and by the eager route;
    every output equal, each generator's state after its batch equal, the
    launch counters moved alike.  The graph is captured once, in the first
    batch, and the second batch is all replays."""
    gen, cvae = _models(card)
    norm, consts, parents = _character(gen, card)
    frames, S = 48, 64
    batches = [_batch(gen, norm, card, S, frames, seed=100 + 100 * b)
               for b in range(2)]
    seeds = [2 ** 31 + 17, 5]

    def runner():
        return stream.make_batch_runner(gen, cvae, consts, parents,
                                        compute_cm=False,
                                        root_dtype=torch.float64,
                                        device=card)

    before = _graph_counters()
    graph = _run_batches(runner(), batches, seeds, card)
    captures, replays, eager = (a - b for a, b in
                                zip(_graph_counters(), before))
    assert (captures, replays, eager) == (1, 2 * (frames - 1) - 1, 0)
    with eager_route():
        plain = _run_batches(runner(), batches, seeds, card)
    for b, ((go, gs, gc), (eo, es, ec)) in enumerate(zip(graph, plain)):
        _equal(go, eo, f"batch {b}")
        assert torch.equal(gs, es), f"batch {b}: generator state"
        assert gc == ec, (b, gc, ec)
        assert gc["pose_roots"] == gc["pose_ik"] == frames - 1
        assert gc["launches"] > 0 and gc["pose_eager"] == 0


@pytest.mark.card
def test_card_graph_grouped_runner_equals_eager_bit_for_bit(card,
                                                            eager_route):
    """The generator alone over a 30-character stack, S = 256 streams
    round-robin over it, float64 roots: graph = eager, picks included."""
    gen, _ = _models(card)
    chars = [_character(gen, card, seed=200 + c, frames=100 - c)
             for c in range(30)]
    norm, _, parents = chars[0]
    stack = stream.stack_consts([c[1] for c in chars])
    S, frames = 256, 24
    batch = _batch(gen, norm, card, S, frames, seed=300)
    cids = np.arange(S) % 30

    def runner():
        return stream.make_batch_runner(gen, None, stack, parents,
                                        compute_cm=False,
                                        root_dtype=torch.float64,
                                        multi_character=True, device=card)

    graph = _run_batches(runner(), [batch, batch], [1, 2], card,
                         char_ids=cids)
    with eager_route():
        plain = _run_batches(runner(), [batch, batch], [1, 2], card,
                             char_ids=cids)
    for (go, _, gc), (eo, _, ec) in zip(graph, plain):
        _equal(go, eo, "grouped")
        assert gc == ec
    _equal(graph[0][0], graph[1][0], "the same batch again")


@pytest.mark.card
def test_card_graph_live_equals_eager_bit_for_bit(card, eager_route):
    """A live session with the CVAE's noise over 300 frames, reset after
    the 150th: every pose equal by both routes, the generators' states
    equal after, one capture (kept through the reset), the launch counters
    moved alike."""
    gen, cvae = _models(card)
    norm, consts, parents = _character(gen, card)
    rows = _live_rows(gen, norm, card, 150)
    rows = rows + rows[::-1]

    def session():
        g = torch.Generator(device=card).manual_seed(2 ** 33 + 7)
        live = LiveCharacterizer(gen, cvae, consts, parents, device=card,
                                 generator=g)
        before = _counters()
        poses = []
        for i, r in enumerate(rows):
            if i == len(rows) // 2:
                live.reset()
            poses.append(live.push_frame(r))
        after = _counters()
        return poses, g.get_state(), {k: after[k] - before[k]
                                      for k in after}

    before = _graph_counters()
    graph = session()
    assert tuple(a - b for a, b in zip(_graph_counters(), before)) \
        == (1, len(rows) - 3, 0)
    with eager_route():
        plain = session()
    for i, (a, b) in enumerate(zip(graph[0], plain[0])):
        for k in a:
            assert np.array_equal(a[k], b[k]), (i, k)
    assert torch.equal(graph[1], plain[1])
    assert graph[2] == plain[2]
    assert graph[2]["pose_roots"] == len(rows) - 2
