"""The encoder's chunks as CUDA graph replays (``runtime/features``).

On the CPU: every call takes the eager route and moves none of the chunk
graph's counters; the chunks' outputs, assembled into outputs allocated
once, equal the concatenation of the chunks run one by one, bit for bit,
and do not depend on the chunk size beyond float32 rounding.

On a card (``card`` tests, skipped on a host without one): the graph route
held bit for bit (max |d| 0) to the eager route, forced by
:func:`features._route`, at S = 64 clips of 255 raw frames (120 full
chunks), at a shape whose last chunk is shorter, with and without ``cnt``
and with a bfloat16 encoder; the attention launch counters move alike on
both routes, one capture a call and a replay a full chunk but the first,
no eager chunk, and the frame step's graph counters stay still.  Run them
on the card with ``python -m pytest --noconftest
tests/test_torch_features_graph.py`` (the suite's conftest imports JAX,
which that machine lacks).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mocha_sigasia2023_torch.cli.characterize import (  # noqa: E402
    derive_norm)
from mocha_sigasia2023_torch.data.preprocess import (  # noqa: E402
    ARRAY_KEYS, featurize_clip)
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.data.windows import (  # noqa: E402
    padded_window_indices)
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, init_generator)
from mocha_sigasia2023_torch.ops import attention  # noqa: E402
from mocha_sigasia2023_torch.runtime import (  # noqa: E402
    features, step_graph)

CPU = torch.device("cpu")
# tiny widths; head dims of 64 keep every attention on the tuned kernels
CFG = GeneratorConfig(encoder_dim=64, encoder_heads=2, encoder_dim_head=64,
                      encoder_mlp_dim=64, decoder_dim=64, decoder_heads=2,
                      decoder_dim_head=64, decoder_mlp_dim=64)
PAD = CFG.nframes // 4     # frames a clip has beyond its windows


def _clips(streams, frames, seed):
    return [make_mocha_bvh_data(T=frames, seed=seed + i)
            for i in range(streams)]


def _counters():
    f = attention.fused_attention
    return {"launches": f.launches, "launches_bf16": f.launches_bf16,
            "launches_general": f.launches_general}


def _chunk_counters():
    return (features.chunk_captures, features.chunk_replays,
            features.eager_chunks)


def _graph_counters():
    return (step_graph.captures, step_graph.replays, step_graph.eager_steps)


def _equal(a, b, where):
    assert set(a) == set(b), where
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        assert a[k].shape == b[k].shape, (where, k)
        d = (a[k].double() - b[k].double()).abs().max().item()
        assert d == 0, (where, k, d)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_pipe():
    torch.set_num_threads(2)
    gen = init_generator(CFG, seed=1, device=CPU)
    norm = derive_norm(make_mocha_bvh_data(T=110, seed=3), CFG.nframes, CPU)
    return dict(gen=gen, norm=norm)


@pytest.mark.parametrize("case", ["no_grad", "grad", "one_chunk"])
def test_cpu_route_is_eager_and_counts_nothing(case):
    before = _chunk_counters(), _graph_counters()
    like = torch.zeros(3)
    if case == "grad":
        with torch.enable_grad():
            assert features._route(like, 5) == "eager"
    else:
        with torch.no_grad():
            assert features._route(like, 1 if case == "one_chunk" else 5) \
                == "eager"
    assert (_chunk_counters(), _graph_counters()) == before


def _fake_encode(ci, cp):
    """Outputs of several widths and dtypes from a chunk's rows, one a
    strided view, as the chunk body's are."""
    rows = ci.to(torch.float32)[:, :, None] * cp[:, None, :].float()
    return {"wide": rows, "last": rows[:, -1], "sum": ci.sum(1),
            "flag": cp[:, 0]}


@pytest.mark.parametrize("n,chunk", [(96, 32), (100, 32), (20, 32),
                                     (128, 128)])
def test_cpu_chunks_assemble_as_concatenated(n, chunk):
    g = torch.Generator().manual_seed(n)
    flat_idx = torch.randint(0, 1000, (n, 6), generator=g)
    flat_pad = torch.rand(n, 6, generator=g) < 0.3
    before = _chunk_counters()
    got = features._encode_chunks(_fake_encode, flat_idx, flat_pad, chunk)
    parts = [_fake_encode(flat_idx[s:s + chunk], flat_pad[s:s + chunk])
             for s in range(0, n, chunk)]
    want = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    assert _chunk_counters() == before
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
        assert got[k].is_contiguous(), k


@pytest.mark.parametrize("emit_cnt", [True, False], ids=["cnt", "no_cnt"])
def test_cpu_features_equal_the_chunks_concatenated(cpu_pipe, emit_cnt):
    """batch_stream_features_device's outputs equal the chunk body's over
    each chunk, concatenated, bit for bit (3 clips of 58 frames: 129
    windows, four chunks of 32 and one of 1)."""
    p = cpu_pipe
    clips = _clips(3, 58, seed=20)
    frame0, xs = features.batch_stream_features_device(
        clips, p["gen"], p["norm"], chunk=32, emit_cnt=emit_cnt, device=CPU)

    # the chunks concatenated, as the port assembled them before
    c0 = clips[0]
    rot = torch.as_tensor(np.stack([c["rotations"] for c in clips]),
                          dtype=torch.float32)
    pos = torch.as_tensor(np.stack([c["positions"] for c in clips]),
                          dtype=torch.float32)
    S, T = rot.shape[:2]
    feats = featurize_clip(rot, pos, c0["order"], c0["names"], c0["parents"],
                           contact_velocity_threshold=0.5, fps=60.0)
    pf = features._per_frame_world({k: feats[k] for k in ARRAY_KEYS},
                                   feats["bone_parents"])
    pf = {k: v.reshape((S * T,) + v.shape[2:]) for k, v in pf.items()}
    idx, pad = padded_window_indices(T, CFG.nframes, 1)
    n_w = len(idx)
    flat_idx = torch.as_tensor(
        (np.arange(S)[:, None, None] * T + idx[None]).reshape(-1,
                                                              CFG.nframes),
        dtype=torch.long)
    flat_pad = torch.as_tensor(np.tile(pad, (S, 1)))
    X_mean = torch.as_tensor(p["norm"]["X_mean"], dtype=torch.float32)
    X_std = torch.as_tensor(p["norm"]["X_std"], dtype=torch.float32)
    with torch.no_grad():
        parts = [features._chunk_outputs(
            pf, flat_idx[s:s + 32], flat_pad[s:s + 32], feats["bone_parents"],
            p["gen"], X_mean, X_std, emit_cnt, None)
            for s in range(0, S * n_w, 32)]
    want = {k: torch.cat([q[k] for q in parts]).reshape(
        (S, n_w) + parts[0][k].shape[1:]) for k in parts[0]}
    got = {k: torch.cat([frame0[k][:, None], xs[k].transpose(0, 1)], dim=1)
           for k in frame0}
    _equal(got, want, f"emit_cnt={emit_cnt}")


def test_cpu_features_do_not_depend_on_the_chunk(cpu_pipe):
    """Chunks of 64 and of 128 windows (129 windows: a short last chunk
    each), and one chunk of all, agree within float32 rounding."""
    p = cpu_pipe
    clips = _clips(3, 58, seed=30)
    outs = [features.batch_stream_features_device(
        clips, p["gen"], p["norm"], chunk=chunk, device=CPU)[1]
        for chunk in (64, 128, 129)]
    for other in outs[1:]:
        for k in outs[0]:
            torch.testing.assert_close(other[k], outs[0][k], rtol=1e-5,
                                       atol=1e-5, msg=k)


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


@pytest.fixture(scope="module")
def card_models():
    """The generator in float32 and in bfloat16, and a norm (made on the
    card when the first card test asks)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs run on a CUDA card; this host has none")
    dev = torch.device("cuda", 0)
    gen = init_generator(CFG, seed=1, device=dev)
    norm = derive_norm(make_mocha_bvh_data(T=110, seed=3), CFG.nframes, dev)
    return {"float32": gen,
            "bfloat16": copy.deepcopy(gen).to(torch.bfloat16)}, norm


def _run(gen, norm, clips, dev, **kw):
    """(frame0, xs, the launch and chunk counters it moved)."""
    before, chunks = _counters(), _chunk_counters()
    frame0, xs = features.batch_stream_features_device(
        clips, gen, norm, device=dev, **kw)
    torch.cuda.synchronize()
    after = _counters()
    return ({k: v.clone() for k, v in frame0.items()},
            {k: v.clone() for k, v in xs.items()},
            {k: after[k] - before[k] for k in after},
            tuple(a - b for a, b in zip(_chunk_counters(), chunks)))


@pytest.mark.card
@pytest.mark.parametrize("streams,frames,emit_cnt,dtype", [
    (64, 255, True, "float32"),       # 15,360 windows: 120 full chunks
    (64, 255, False, "float32"),
    (5, 80, True, "float32"),         # 325 windows: 2 full chunks and 69
    (64, 255, True, "bfloat16"),
    (5, 80, False, "bfloat16"),
], ids=["64x255", "64x255-no-cnt", "5x80-short-last", "64x255-bf16",
        "5x80-no-cnt-bf16"])
def test_card_graph_features_equal_eager_bit_for_bit(
        card, card_models, monkeypatch, streams, frames, emit_cnt, dtype):
    gens, norm = card_models
    gen = gens[dtype]
    clips = _clips(streams, frames, seed=100 + streams)
    kw = dict(emit_cnt=emit_cnt, compute_dtype=(
        torch.bfloat16 if dtype == "bfloat16" else None))
    windows = streams * (frames - PAD)
    full = windows // 128

    graphs = _graph_counters()
    f0g, xsg, launches_g, chunks_g = _run(gen, norm, clips, card, **kw)
    assert chunks_g == (1, full - 1, 0)
    with monkeypatch.context() as m:
        m.setattr(features, "_route", lambda like, full_chunks: "eager")
        f0e, xse, launches_e, chunks_e = _run(gen, norm, clips, card, **kw)
    assert chunks_e == (0, 0, 0)
    assert _graph_counters() == graphs
    _equal(f0g, f0e, "frame0")
    _equal(xsg, xse, "xs")
    assert launches_g == launches_e
    assert sum(launches_g.values()) > 0 and launches_g["launches_general"] == 0


@pytest.mark.card
def test_card_features_under_grad_go_eager_and_count(card, card_models):
    """A call on a card with grad on takes the eager route: its full chunks
    but the first count in ``eager_chunks``, no graph is captured, and the
    outputs equal a graphed call's."""
    gens, norm = card_models
    gen = gens["float32"]
    clips = _clips(4, 79, seed=7)           # 256 windows: 2 full chunks
    args = (gen, norm, CFG.nframes, 128, True, None, card)
    chunks = _chunk_counters()
    with torch.no_grad():
        graphed = features._clip_windows(clips, *args)
    with torch.enable_grad():
        eager = features._clip_windows(clips, *args)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_chunk_counters(), chunks)) \
        == (1, 1, 1)
    _equal(graphed, eager, "grad on")
