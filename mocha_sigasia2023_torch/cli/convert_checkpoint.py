"""Convert reference (.pt) and JAX package (.msgpack) checkpoints to the
port's own format (.ckpt).

Counterpart of mocha_sigasia2023_tpu/cli/convert_checkpoint.py.  Sources:
the reference trainer's ``gen_*.pt`` (``{'gen', 'gen_ema', 'gen_opt'}``),
the CVAE's ``cvae_*.pt`` (a bare state dict), a projector state dict, and
the JAX package's msgpack checkpoints (``gen_*.msgpack`` with ``gen``,
``gen_ema`` and ``prj``; ``cvae_*.msgpack`` with ``cvae``; a converted
``{"prj": ...}``).  The JAX ``opt_state`` is read and left unused.  Writes:

- ``--kind gen``: ``{"gen", "gen_ema"}`` state dicts (and ``prj`` when the
  source holds one), which ``train/trainer.load_generator`` and
  ``characterize --gen-ckpt`` read;
- ``--kind cvae``: ``{"cvae", "iteration"}``, as ``cli/train_cvae`` writes
  it (the iteration from the source's file name);
- ``--kind projector``: ``{"prj"}``.

Widths come from ``--config`` (the port's by default) with the depth
flags overriding its generator's and CVAE's depth.

Run: python -m mocha_sigasia2023_torch.cli.convert_checkpoint \\
         --kind gen model_ours/pth/gen_125.msgpack out/gen_125.ckpt
"""

from __future__ import annotations

import argparse

from ..io.msgpack import read_msgpack
from ..models import CVAEConfig, GeneratorConfig, convert
from ..models.projector import ProjectorConfig
from ..train.checkpoint import epoch_from_path, save_checkpoint
from ..utils import get_config
from .characterize import DEFAULT_CONFIG


def _state(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _cvae_state_dict(obj):
    """A reference CVAE file's state dict (bare, or under
    ``state_dict``)."""
    if isinstance(obj, dict) and "prior_net.mu_token" not in obj:
        return obj.get("state_dict", obj)
    return obj


def convert_file(src: str, kind: str, gen_cfg: GeneratorConfig,
                 cvae_cfg: CVAEConfig, prj_cfg: ProjectorConfig) -> dict:
    """The port checkpoint's contents for ``src`` (.pt or .msgpack)."""
    jax_file = src.endswith(".msgpack")
    obj = read_msgpack(src) if jax_file else convert.load_torch_file(src)
    dev = "cpu"
    if kind == "gen":
        build = convert.generator_from_jax if jax_file \
            else convert.generator_from_torch
        out = {k: _state(build(obj[k], gen_cfg, device=dev))
               for k in ("gen", "gen_ema")}
        if jax_file and "prj" in obj:
            out["prj"] = _state(convert.projector_from_jax(
                obj["prj"], prj_cfg, device=dev))
        return out
    if kind == "cvae":
        cvae = convert.cvae_from_jax(obj["cvae"], cvae_cfg, device=dev) \
            if jax_file else convert.cvae_from_torch(
                _cvae_state_dict(obj), cvae_cfg, device=dev)
        return {"cvae": _state(cvae), "iteration": epoch_from_path(src)}
    prj = convert.projector_from_jax(obj["prj"], prj_cfg, device=dev) \
        if jax_file else convert.projector_from_torch(obj, prj_cfg,
                                                      device=dev)
    return {"prj": _state(prj)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="reference .pt or JAX .msgpack checkpoint")
    ap.add_argument("dst", help="output .ckpt path")
    ap.add_argument("--kind", choices=["gen", "cvae", "projector"],
                    default="gen")
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--encoder-depth", type=int, default=None)
    ap.add_argument("--decoder-depth", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.src.endswith((".pt", ".msgpack")):
        raise SystemExit(f"{args.src}: not a .pt or .msgpack checkpoint")

    config = get_config(args.config)
    model = dict(config["model"])
    if args.encoder_depth is not None:
        model["encoder_depth"] = args.encoder_depth
    if args.decoder_depth is not None:
        model["decoder_depth"] = args.decoder_depth
    gen_cfg = GeneratorConfig.from_dict(model)
    cvae = config.get("cvae", {})
    cvae_cfg = CVAEConfig(
        output_seq=gen_cfg.num_tokens,
        latent_dim=cvae.get("latent_dim", 256),
        depth=(args.encoder_depth if args.encoder_depth is not None
               else cvae.get("depth", 2)),
        nheads=cvae.get("nheads", 4),
        feedforward_dim=cvae.get("feedforward_dim", 512))
    prj_cfg = ProjectorConfig(
        mode="all", num_patches=model.get("num_patches", -1),
        encoder_dim=gen_cfg.encoder_dim, prj_dim=model.get("prj_dim", 1024),
        nframes=gen_cfg.nframes,
        temporal_patch_size=gen_cfg.temporal_patch_size)
    save_checkpoint(args.dst, convert_file(args.src, args.kind, gen_cfg,
                                           cvae_cfg, prj_cfg))
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
