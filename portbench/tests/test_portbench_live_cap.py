"""The live window's frame cap (``window_frames``): the window ends at the
cap or on the clock, whichever comes first; the check still replays every
frame the session served; and a planted fault still fails a capped run.
The CPU and the tiny live cell."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, harness, run
from portbench.tests import tiny
from portbench.traffic import live

CELL = "cvae-live-1"
CPU = torch.device("cpu")
CAP = 12
SEED = 2 ** 31 + 707


def tiny_cell(tmp_path, **mix):
    name = tiny.write(str(tmp_path), CELL, **mix)
    return harness.load_cell(name, str(tmp_path))


def serve(cell, seconds):
    """The window's record of one tiny session, and the window's seconds."""
    session = live.setup(cell, SEED, CPU,
                         harness.implementation(harness.PROGRAM))
    t0 = time.perf_counter()
    rec = live.window(cell, session, seconds, False)
    return rec, time.perf_counter() - t0


def test_the_cap_ends_a_long_window(tmp_path):
    rec, took = serve(tiny_cell(tmp_path, window_frames=CAP), 60.0)
    assert rec["ended_by"] == "cap"
    assert rec["attempted"] == rec["window_frames"] == CAP
    assert took < 20.0


@pytest.mark.parametrize("window_frames", [None, 10 ** 6],
                         ids=["absent", "out_of_reach"])
def test_the_clock_ends_a_window_the_cap_does_not(window_frames, tmp_path):
    cell = tiny_cell(tmp_path, window_frames=window_frames)
    assert ("window_frames" in cell.mix) == (window_frames is not None)
    rec, took = serve(cell, 0.5)
    assert rec["ended_by"] == "clock"
    assert took >= 0.5
    assert rec["attempted"] == rec["window_frames"] >= 1


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_the_check_replays_every_frame_served(traced, tmp_path,
                                              monkeypatch, capsys):
    replayed = []
    push = live.PlainLive.push_frame

    def counted(self, row, nn_idx=None):
        replayed.append(nn_idx)
        return push(self, row, nn_idx)

    monkeypatch.setattr(live.PlainLive, "push_frame", counted)
    cell = tiny_cell(tmp_path, window_frames=CAP)
    result = run.run_cell(cell, SEED, 60.0, traced, CPU)
    profiled = int(cell.mix["profile_frames"]) if traced else 0
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == profiled + CAP
    # bootstrap, warm-up, profiled and window frames, each replayed once
    assert len(replayed) == 1 + int(cell.mix["warmup_frames"]) + profiled \
        + CAP
    assert (f"live window: {CAP} frames, ended by the cap"
            in capsys.readouterr().err)


@pytest.mark.parametrize("fault", sorted(faults.for_kind("live")))
def test_a_planted_fault_fails_a_capped_window(fault, tmp_path):
    cell = tiny_cell(tmp_path, window_frames=CAP)
    with faults.for_kind("live")[fault]():
        result = run.run_cell(cell, SEED, 60.0, False, CPU)
    assert result["attempted"] == CAP
    assert result["correct"] is False, result["checks"]
