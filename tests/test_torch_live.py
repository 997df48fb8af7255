"""The port's live (frame-at-a-time) session against its offline runner and
against the JAX package's LiveCharacterizer.

Small widths, deterministic CVAE, float32 roots, one source clip of 65
frames fed one frame at a time (tests/test_runtime.py:854-907).  The
session must reproduce the port's ``characterize_clip`` over 12 frames and
after a ``reset`` within 1e-5 / 1e-4, with identical picks, and JAX's
session within 1e-3 (PARITY.md:87).  The pipelined form lags by one frame
and is otherwise identical.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from mocha_sigasia2023_tpu.runtime.live import (  # noqa: E402
    LiveCharacterizer as JLive)

from mocha_sigasia2023_torch.runtime import features as tfeat  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream as tstream  # noqa: E402
from mocha_sigasia2023_torch.runtime.live import LiveCharacterizer  # noqa: E402

from test_torch_multi import build_pipe  # noqa: E402

torch.set_num_threads(2)
FRAMES = 12
KEYS = ("trans_pos", "ik_pos", "cm_pos")


@pytest.fixture(scope="module")
def pipe():
    p = build_pipe(n_src=1)
    src = tfeat.clip_stream_features_device(p["clips"][0], p["tg"],
                                            p["norm"], device="cpu")
    p["src"] = {k: v.numpy() for k, v in src.items() if torch.is_tensor(v)}
    return p


def _frames(pipe, n=FRAMES):
    return [{k: pipe["src"][k][i] for k in LiveCharacterizer.FEAT_KEYS}
            for i in range(n)]


def _live(pipe, **kw):
    kw.setdefault("deterministic", True)
    return LiveCharacterizer(pipe["tg"], pipe["tc"], pipe["consts_t"][0],
                             pipe["parents"], device="cpu", **kw)


def _close(a, b, atol, rtol=0.0, msg=""):
    assert a["nn_index"] == b["nn_index"], msg
    for k in KEYS:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=f"{msg} {k}")


def test_live_matches_characterize_clip(pipe):
    offline = tstream.characterize_clip(
        pipe["tg"], pipe["tc"], pipe["consts_t"][0], pipe["parents"],
        {k: torch.as_tensor(v) for k, v in pipe["src"].items()},
        deterministic=True, root_dtype=torch.float32, device="cpu")
    live = _live(pipe)
    frames = _frames(pipe)
    for i, f in enumerate(frames):
        out = live.push_frame(f)
        assert set(out) == set(LiveCharacterizer.OUT_KEYS)
        assert out["ik_pos"].shape == (25, 3) and out["ik_rot"].shape == (
            25, 4)
        _close(out, {k: v[i] for k, v in offline.items()}, 1e-5, 1e-4,
               f"frame {i}")
    live.reset()
    _close(live.push_frame(frames[0]), {k: v[0] for k, v in offline.items()},
           1e-5, 1e-4, "after reset")


def test_live_matches_jax_live(pipe):
    jlive = JLive(pipe["params"], pipe["jcfg"], pipe["cparams"],
                  pipe["jccfg"], pipe["consts_j"][0], pipe["parents"],
                  deterministic=True)
    live = _live(pipe)
    for i, f in enumerate(_frames(pipe)):
        want = jlive.push_frame(f)
        got = live.push_frame(f)
        _close(got, want, 1e-3, msg=f"frame {i}")
        for k in ("src_pos", "trans_rot", "ik_rot", "cm_rot"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-3,
                                       err_msg=f"frame {i} {k}")


def test_pipelined_lags_one_frame(pipe):
    frames = _frames(pipe, 6)
    live = _live(pipe)
    direct = [live.push_frame(f) for f in frames]
    live.reset()
    piped = [live.push_frame_pipelined(f) for f in frames]
    assert piped[0] is None
    with pytest.raises(RuntimeError, match="flush"):
        live.push_frame(frames[0])
    piped = piped[1:] + [live.flush()]
    for i, (a, b) in enumerate(zip(direct, piped)):
        _close(a, b, 1e-6, msg=f"frame {i}")
    assert live.flush() is None
    live.push_frame(frames[0])    # drained: direct calls work again


def test_stochastic_live_follows_its_generator(pipe):
    frames = _frames(pipe, 4)
    outs = []
    for _ in range(2):
        live = _live(pipe, deterministic=False,
                     generator=torch.Generator().manual_seed(3))
        outs.append([live.push_frame(f) for f in frames])
    for a, b in zip(*outs):
        _close(a, b, 0.0)
        assert np.isfinite(a["ik_pos"]).all()
    default = _live(pipe, deterministic=False)   # seeded with 1777
    assert np.isfinite(default.push_frame(frames[0])["trans_pos"]).all()
