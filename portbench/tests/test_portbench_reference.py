"""The plain reference against the port at a tiny size on the CPU (where
the port's attention takes its plain version): the same functions give
the same numbers from the same weights, and every cell's run through the
harness is correct, its compared numbers within the cells' limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, run, weights
from portbench.tests import tiny
from portbench.traffic import common

PORT = harness.implementation(harness.PROGRAM)
REF = harness.implementation("portbench.reference")


def models(impl, config, seed=11):
    return common.serving_models(impl, config, seed, torch.device("cpu"))


def test_weights_from_a_seed_are_the_same_on_both_sides():
    config = harness.load_cell("cvae-offline-64x240").config
    (pg, pc), (rg, rc) = models(PORT, config), models(REF, config)
    weights.same_layout(pg, rg)
    weights.same_layout(pc, rc)
    for a, b in ((pg, rg), (pc, rc)):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n
    # another seed, other weights
    other, _ = models(PORT, config, seed=12)
    assert not torch.equal(next(pg.parameters()), next(other.parameters()))


@torch.no_grad()
def test_encode_sample_and_decode_agree():
    config = harness.load_cell("cvae-offline-64x240").config
    config["model"] = dict(config["model"], **tiny.WIDTHS)
    config["cvae"] = dict(config["cvae"], latent_dim=32, feedforward_dim=32)
    (pg, pc), (rg, rc) = models(PORT, config), models(REF, config)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 60, 24, 15, generator=g)
    pe, re = PORT.generator.encode(pg, x), REF.generator.encode(rg, x)
    torch.testing.assert_close(pe, re, rtol=1e-5, atol=1e-5)
    cond = torch.randn(5, 180, 32, generator=g)
    ps = PORT.cvae.sample(pc, cond, generator=torch.Generator().manual_seed(4))
    rs = REF.cvae.sample(rc, cond, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(ps, rs, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(PORT.generator.decode(pg, pe, ps),
                               REF.generator.decode(rg, re, rs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(tiny.SIZES))
def test_every_cell_is_correct_against_the_reference(cell, tmp_path):
    name = tiny.write(str(tmp_path), cell)
    result = run.run_cell(harness.load_cell(name, str(tmp_path)),
                          2 ** 31 + 101, 0.2, False, torch.device("cpu"))
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    for c in result["checks"].values():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"]
