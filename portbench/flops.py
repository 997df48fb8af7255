"""Model FLOPs of the MOCHA model, counted from the configuration's shapes.

Each count runs the plain reference (:mod:`portbench.reference`) on
``meta`` tensors, which carry shapes and no data, under
``torch.utils.flop_counter.FlopCounterMode``: the operations of every
matrix product, convolution and attention product of the call, as the
configuration's widths make them.  Elementwise work (norms, softmax,
kinematics) is not counted, so the share of the float32 peak these give
is a share of the products' rate.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.models import cvae as cvae_mod
from .reference.models import generator as gen_mod
from .reference.models import projector as prj_mod
from .reference.train import trainer as trainer_mod

META = torch.device("meta")


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta(module):
    return module.to(META)


def generator_config(config: dict) -> gen_mod.GeneratorConfig:
    return gen_mod.GeneratorConfig.from_dict(config["model"])


def cvae_config(config: dict) -> cvae_mod.CVAEConfig:
    c = config["cvae"]
    gcfg = generator_config(config)
    return cvae_mod.CVAEConfig(
        output_seq=gcfg.num_tokens, latent_dim=int(c["latent_dim"]),
        depth=int(c["depth"]), nheads=int(c["nheads"]),
        feedforward_dim=int(c["feedforward_dim"]),
        dropout=float(c["dropout"]))


@torch.no_grad()
def encode_flops(config: dict, windows: int) -> int:
    """One encoder call over ``windows`` motion windows."""
    cfg = generator_config(config)
    gen = _meta(gen_mod.Generator(cfg))
    x = torch.empty(windows, cfg.nframes, cfg.njoints, cfg.mot_in_dim,
                    device=META)
    return _count(lambda: gen_mod.encode(gen, x))


@torch.no_grad()
def decode_flops(config: dict, streams: int) -> int:
    """One decoder call for ``streams`` streams."""
    cfg = generator_config(config)
    gen = _meta(gen_mod.Generator(cfg))
    enc = torch.empty(streams, cfg.num_tokens, cfg.encoder_dim, device=META)
    return _count(lambda: gen_mod.decode(gen, enc, enc))


@torch.no_grad()
def cvae_sample_flops(config: dict, streams: int) -> int:
    """One CVAE prior sample for ``streams`` streams (the condition is the
    source's context tokens beside the last character tokens)."""
    cfg = generator_config(config)
    cvae = _meta(cvae_mod.CVAE(cvae_config(config)))
    cond = torch.empty(streams, 2 * cfg.num_tokens, cfg.encoder_dim,
                       device=META)
    return _count(lambda: cvae_mod.sample(cvae, cond, deterministic=True))


def match_flops(config: dict, database_rows: int) -> int:
    """One nearest-neighbour query against ``database_rows`` rows: the
    product of the flattened context tokens with every row."""
    cfg = generator_config(config)
    return 2 * cfg.num_tokens * cfg.encoder_dim * int(database_rows)


def offline_batch_flops(config: dict, streams: int, frames: int,
                        rows_per_stream, chunk: int = 128) -> int:
    """One batch of ``streams`` clips of ``frames`` output frames: the
    encoder over every window in ``chunk``-window calls, one decode a frame
    for all streams (frame 0 against the match, then one a step), one CVAE
    sample a step when the configuration has a CVAE, and one match a
    (frame, stream) against that stream's database (``rows_per_stream``)."""
    windows = streams * frames
    full, rest = divmod(windows, chunk)
    total = full * encode_flops(config, chunk)
    if rest:
        total += encode_flops(config, rest)
    total += frames * decode_flops(config, streams)
    if config.get("cvae") is not None:
        total += (frames - 1) * cvae_sample_flops(config, streams)
    total += frames * sum(match_flops(config, r) for r in rows_per_stream)
    return total


def train_step_flops(config: dict, batch: int) -> int:
    """One generator training step at ``batch``: the six forwards of the
    loss and its backward (the optimizer's elementwise work uncounted)."""
    cfg = generator_config(config)
    m = config["model"]
    pcfg = prj_mod.ProjectorConfig(
        mode="all", num_patches=m.get("num_patches", -1),
        encoder_dim=cfg.encoder_dim, prj_dim=m.get("prj_dim", 1024),
        nframes=cfg.nframes, temporal_patch_size=cfg.temporal_patch_size)
    gen = _meta(gen_mod.Generator(cfg))
    prj = _meta(prj_mod.Projector(pcfg))
    J = cfg.njoints + 1

    def window():
        return torch.empty(batch, cfg.nframes, J, cfg.mot_in_dim,
                           device=META)

    norm = {k: torch.empty(J, cfg.mot_in_dim, device=META)
            for k in ("X_mean", "X_std", "Y_mean", "Y_std")}
    parents = np.concatenate(
        [[-1], np.asarray(config["dataset"]["mocha"]["parents"]) + 1])
    weights = {k: float(config[k]) for k in ("rec_w", "nce_w", "cyc_w")}

    def step():
        total, _, _ = trainer_mod.compute_gen_loss(
            gen, prj, pcfg, {"X": window(), "Y": window()},
            {"X": window(), "Y": window()}, norm, parents, weights, None)
        total.backward()

    return _count(step)
