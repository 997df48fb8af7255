"""Tiny copies of the benchmark's cells, written as files under a
directory of their own, as a later change would add a cell: small widths
and sizes that run on the CPU in seconds, with the real cells' limits."""

from __future__ import annotations

import json
import os

from portbench import harness

WIDTHS = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
              encoder_mlp_dim=32, decoder_dim=32, decoder_heads=2,
              decoder_dim_head=16, decoder_mlp_dim=32, prj_dim=16)
# tiny mix parameters over the real mixes' (the real cell -> tiny sizes)
SIZES = {
    "cvae-offline-64x240": dict(streams=3, frames=60, pool=5,
                                database_windows=70, window_step=4),
    "gen-nn-30style-256x240": dict(streams=4, frames=60, pool=6,
                                   characters=2, database_windows=70,
                                   window_step=4),
    "cvae-live-1": dict(clip_frames=60, database_windows=70,
                        warmup_frames=3, profile_frames=4),
    "gen-train-b64": dict(batch=4, clips=3, clip_frames=100,
                          profile_steps=2),
}


def write(root: str, real_cell: str, name: str = None, **mix) -> str:
    """Write a tiny copy of ``real_cell`` under ``root``; returns its name.
    ``mix`` sets parameters of its traffic mix over the tiny sizes (None
    leaves one out)."""
    real = harness.load_cell(real_cell)
    name = name or f"tiny-{real_cell}"
    for sub in ("workloads", "configs", "traffic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    config = json.loads(json.dumps(real.config))
    config["model"].update(WIDTHS)
    if config.get("cvae") is not None:
        config["cvae"].update(latent_dim=32, feedforward_dim=32)
    mix = {k: v for k, v in dict(real.mix, **SIZES[real_cell], **mix).items()
           if v is not None}
    spec = dict(real.spec, config=f"{name}-config", traffic=f"{name}-mix")
    for sub, stem, obj in (("configs", spec["config"], config),
                           ("traffic", spec["traffic"], mix),
                           ("workloads", name, spec)):
        with open(os.path.join(root, sub, f"{stem}.json"), "w") as f:
            json.dump(obj, f)
    return name
