"""The port's profiling helpers and its matplotlib animation against the
JAX package's, on the CPU: ``StageTimer``'s ``report()`` and
``summary()`` on the same recorded totals, ``device_trace``'s trace file,
``animation_plot`` on tests/test_viz.py's animations (Agg, frame 0's RGBA
canvas pixel for pixel), and ``characterize --viz``."""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip(
    "matplotlib", reason="the viz tests need matplotlib")
matplotlib.use("Agg")
pytest.importorskip("jax")

from mocha_sigasia2023_tpu.utils import profiling as jprof  # noqa: E402
from mocha_sigasia2023_tpu.viz import animation_plot as janimation  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize as tchar  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh  # noqa: E402
from mocha_sigasia2023_torch.utils import profiling as tprof  # noqa: E402
from mocha_sigasia2023_torch.viz import animation_plot  # noqa: E402

torch.set_num_threads(2)
PARENTS = np.concatenate(
    [[-1], np.array([-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13,
                     14, 8, 16, 17, 18, 0, 20, 21, 22]) + 1])


def _tiny_anim(T=3, seed=0):
    """tests/test_viz.py's animation."""
    rng = np.random.RandomState(seed)
    J = len(PARENTS)
    pos = rng.randn(T, J, 3).astype(np.float32) * 0.05
    pos[:, 0, 1] = 1.0
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (T, J, 1))
    contact = (rng.rand(T, 2) > 0.5).astype(np.float32)
    return [pos, rot, contact, np.array([5, 24]), PARENTS]


def _recorded(timer):
    for name, total, n in (("featurize", 0.125, 4), ("encode", 1.5, 3),
                           ("a stage with a long name", 2e-5, 1)):
        timer.totals[name] = total
        timer.counts[name] = n
    return timer


def test_stage_timer_report_and_summary_are_the_jax_ones():
    got, want = _recorded(tprof.StageTimer()), _recorded(jprof.StageTimer())
    assert got.report() == want.report()
    assert got.summary() == want.summary()


def test_stage_timer_times_its_stages():
    timer = tprof.StageTimer()
    for _ in range(2):
        with timer.stage("matmul") as keep:
            keep(torch.ones(8, 8) @ torch.ones(8, 8))
    with timer.stage("unkept", block=False):
        pass
    assert timer.counts == {"matmul": 2, "unkept": 1}
    assert all(t > 0 for t in timer.totals.values())
    assert timer.report().splitlines()[0].startswith("matmul")


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(tmp_path / "trace" / files[0]))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_trace_writes_the_blocks_spans_on_its_timeline(tmp_path):
    tprof.clear()
    with tprof.span("before the block"):
        pass
    with tprof.device_trace(str(tmp_path / "trace")):
        with tprof.span("outer", request=3, rows=64):
            torch.ones(64, 64) @ torch.ones(64, 64)
            with tprof.span("inner"):
                torch.ones(8) + 1
    tprof.clear()
    path = tmp_path / "trace" / os.listdir(tmp_path / "trace")[0]
    events = json.load(open(path))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "port_span"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["args"]["request"] == inner["args"]["request"] == 3
    assert outer["args"]["rows"] == 64
    assert inner["args"]["parent"] == outer["args"]["id"]
    # on the trace's own timeline: the product inside the outer span
    mm, = [e for e in events if e.get("name") == "aten::mm"]
    assert outer["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _frame0(ani):
    ani._init_draw()
    ani._draw_frame(0)
    fig = ani._fig
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("kw", [{}, {"global_space": True,
                                     "show_contacts": False}],
                         ids=["local", "global_no_contacts"])
def test_animation_plot_frame0_is_the_jax_canvas(kw, tmp_path):
    import matplotlib.pyplot as plt

    anims = [_tiny_anim(seed=0), _tiny_anim(seed=1)]
    out = str(tmp_path / "anim.gif")
    got = animation_plot(anims, save_path=out, show=False, **kw)
    assert os.path.getsize(out) > 0
    want = janimation(anims, show=False, **kw)
    a, b = _frame0(got), _frame0(want)
    assert a.shape == b.shape and a.shape[-1] == 4
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 10   # drawn, not blank
    np.testing.assert_array_equal(a, b)
    plt.close("all")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz_cli")
    (d / "src").mkdir()
    for i in range(2):
        bvh.save(str(d / "src" / f"clip_{i}.bvh"),
                 make_mocha_bvh_data(T=70, seed=60 + i))
    bvh.save(str(d / "cha.bvh"), make_mocha_bvh_data(T=140, seed=10_000,
                                                     walk_speed=60.0))
    (d / "config.yaml").write_text(
        "model:\n  encoder_dim: 32\n  encoder_heads: 2\n"
        "  encoder_dim_head: 16\n  encoder_mlp_dim: 64\n  encoder_depth: 1\n"
        "  decoder_dim: 32\n  decoder_heads: 2\n  decoder_dim_head: 16\n"
        "  decoder_mlp_dim: 64\n  decoder_depth: 1\n"
        "cvae:\n  latent_dim: 32\n  depth: 1\n  nheads: 2\n"
        "  feedforward_dim: 64\n")
    return d


def _args(d, *extra):
    return ["--config", str(d / "config.yaml"), "--cha", str(d / "cha.bvh"),
            "--random-init", "--deterministic", "--device", "cpu",
            "--out", str(d / "out"), *extra]


def test_characterize_viz_writes_the_animation(clips):
    out = str(clips / "anim.gif")
    with contextlib.redirect_stdout(None):
        tchar.main(_args(clips, "--src", str(clips / "src" / "clip_0.bvh"),
                         "--viz", out))
    assert os.path.getsize(out) > 0


def test_characterize_viz_is_a_single_clip_option(clips):
    with pytest.raises(SystemExit):
        tchar.main(_args(clips, "--src-dir", str(clips / "src"),
                         "--viz", str(clips / "x.gif")))
    assert not os.path.exists(clips / "x.gif")


def test_characterize_viz_without_matplotlib_names_it(clips, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        tchar.main(_args(clips, "--src", str(clips / "src" / "clip_0.bvh"),
                         "--viz", str(clips / "y.gif")))
