"""chip_smoke.py's parallel phase (13) rehearsed on the CPU at small
widths: two gloo ranks serve 4 streams x 20 frames sharded and take the
first training step, cli/train runs at --data-parallel 1 and 2 in
deterministic mode (and the 1-process run's repeat, bit-identical, its
jittered runs, float32's reach, and one process that sums the blocks'
gradients as the ranks do, at the bars), and
characterize serves the 2-rank checkpoint; every check of the phase
holds but the launch counts, which count on the card only."""

import os

import pytest
import torch
import yaml

import chip_smoke as cs
from mocha_sigasia2023_torch.io import bvh
from mocha_sigasia2023_torch.models.cvae import CVAEConfig
from mocha_sigasia2023_torch.models.generator import GeneratorConfig
from mocha_sigasia2023_torch.utils import config as tconfig

SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parallel_phase_rehearses_on_the_cpu(tmp_path):
    cfg_d = tconfig.get_config(os.path.join(
        cs.REPO, "mocha_sigasia2023_torch", "configs", "config.yaml"))
    cfg_d["model"].update(SMALL, prj_dim=64)
    cfg_d["cvae"].update(latent_dim=32, depth=1, nheads=2,
                         feedforward_dim=64)
    cfg_d["batch_size"] = 8
    config = str(tmp_path / "config.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg_d, f)
    os.makedirs(tmp_path / "bvh")
    for i, name in enumerate(cs.dataset_names(cs.DP_CLIPS)):
        bvh.save(str(tmp_path / "bvh" / f"{name}.bvh"),
                 cs.make_mocha_bvh_data(T=140, seed=3000 + i))
    cfg = GeneratorConfig(**SMALL)
    cvae_cfg = CVAEConfig(output_seq=cfg.num_tokens, latent_dim=32, depth=1,
                          nheads=2, feedforward_dim=64)
    result, launches = cs.parallel_phase(
        cfg, cvae_cfg, torch.device("cpu"), str(tmp_path), streams=4,
        frames=20, db_windows=100, config=config, characterize_frames=100)
    assert launches == (0, 0)          # CPU calls count nothing
    assert [s["streams"] for s in result["serving"]] == [2, 2]
    assert result["train_steps"] >= 4 and result["nccl"] == \
        "not run on the CPU"
    assert max(e for e, _ in result["serving_errors"].values()) <= 1e-3
    assert result["first_step_gradient_worst"][0] <= 1.0
    assert result["train_repeat_identical"]
    half = result["train_half_batch_worst"]
    assert max(half[p][0] for p in ("gen", "prj", "gen_ema")) <= 1.0, half
