"""The control of each cell's check, on the card: the plain reference put
in the program's place with TF32 on has to come out not correct, at the
real widths and smaller counts than the cells' (the chip's full-size
control runs through ``python -m portbench.readings --control``)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, run

# real widths, counts a test run holds
SIZES = {
    "cvae-offline-64x240": dict(streams=16, frames=120, pool=32),
    "gen-nn-30style-256x240": dict(streams=32, frames=120, pool=64,
                                   characters=4),
    "cvae-live-1": dict(clip_frames=200),
    "gen-train-b64": dict(clips=20),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA device; this host has none")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_tf32_control_is_not_correct(cell, card, tmp_path):
    import json
    import os

    real = harness.load_cell(cell)
    for sub in ("workloads", "configs", "traffic"):
        os.makedirs(tmp_path / sub)
    spec = dict(real.spec, traffic="mix")
    (tmp_path / "workloads" / "c.json").write_text(json.dumps(spec))
    (tmp_path / "configs" / f"{spec['config']}.json").write_text(
        json.dumps(real.config))
    (tmp_path / "traffic" / "mix.json").write_text(
        json.dumps(dict(real.mix, **SIZES[cell])))
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        result = run.run_cell(harness.load_cell("c", str(tmp_path)), seed,
                              2.0, False, card,
                              impl_name="portbench.reference",
                              tf32_window=True)
        assert result["correct"] is False, (seed, result["checks"])
