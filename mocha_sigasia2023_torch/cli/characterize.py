"""End-to-end characterization: BVH in, characterized BVH out.

Counterpart of mocha_sigasia2023_tpu/cli/characterize.py.  Given source
BVH clips and a character BVH (plus generator/CVAE checkpoints and
normalization artifacts), re-synthesizes the source motion in the
character's style and writes ``Src_``/``Ours_``/``CM_`` BVHs per clip.
It runs on the GPU unless ``--device cpu`` is given.

Checkpoints: the reference PyTorch files (``model_ours/pth/gen_125.pt``,
``cvae_020000.pt``), the JAX package's msgpack files (``gen_125.msgpack``,
its ``gen_ema`` served; ``cvae_020000.msgpack``, its ``cvae``) and the port
trainers' (``gen_125.ckpt``, its EMA served; ``cvae_020000.ckpt``).  With
``--random-init`` it runs on fresh weights drawn from NumPy seeds (not the
JAX package's ``PRNGKey(1777)`` weights).

Run: python -m mocha_sigasia2023_torch.cli.characterize \\
         --src bvh/Loco_Walk_Neutral_AverageJoe_001.bvh \\
         --cha bvh/Loco_Walk_Neutral_Princess_002.bvh \\
         --gen-ckpt model_ours/pth/gen_125.pt \\
         [--cvae-ckpt .../cvae_020000.pt --cvae-norm .../cvae_norm.npz] \\
         --norm datasets/mocha60/norm.npz --cnt-norm datasets/mocha60/cnt_norm.npz \\
         --out ./results
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..data.dataset import compute_norm_stats, window_xy_features
from ..data.preprocess import featurize_clip
from ..data.windows import window_features
from ..device import resolve_device
from ..io import bvh
from ..io.msgpack import read_msgpack
from ..models import CVAEConfig, GeneratorConfig, convert
from ..models.cvae import init_cvae
from ..models.generator import init_generator
from ..runtime import export as rtexport
from ..runtime import features as rtf
from ..runtime import stream as rts
from ..train import checkpoint
from ..train.trainer import load_generator as load_trained_generator
from ..train.trainer_cvae import load_cvae as load_trained_cvae
from ..utils import ensure_dirs, get_config

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "config.yaml")


JAX_SUFFIX = ".msgpack"


def _require_checkpoint(path: str, flag: str) -> None:
    suffixes = (".pt", JAX_SUFFIX, checkpoint.SUFFIX)
    if not path.endswith(suffixes):
        raise SystemExit(f"{flag} {path}: not a {', '.join(suffixes)} "
                         "checkpoint")


def load_generator(args, cfg: GeneratorConfig, dev):
    if args.gen_ckpt:
        _require_checkpoint(args.gen_ckpt, "--gen-ckpt")
        if args.gen_ckpt.endswith(checkpoint.SUFFIX):
            return load_trained_generator(args.gen_ckpt, cfg, device=dev)
        if args.gen_ckpt.endswith(JAX_SUFFIX):
            return convert.generator_from_jax(
                read_msgpack(args.gen_ckpt)["gen_ema"], cfg, device=dev)
        return convert.load_reference_generator_checkpoint(
            args.gen_ckpt, cfg, device=dev)
    if not args.random_init:
        raise SystemExit("provide --gen-ckpt or pass --random-init")
    return init_generator(cfg, seed=1777, device=dev)


def load_cvae(args, cvae_cfg: CVAEConfig, dev):
    if args.cvae_ckpt:
        _require_checkpoint(args.cvae_ckpt, "--cvae-ckpt")
        if args.cvae_ckpt.endswith(checkpoint.SUFFIX):
            return load_trained_cvae(args.cvae_ckpt, cvae_cfg, device=dev)
        if args.cvae_ckpt.endswith(JAX_SUFFIX):
            return convert.cvae_from_jax(
                read_msgpack(args.cvae_ckpt)["cvae"], cvae_cfg, device=dev)
        return convert.cvae_from_torch(
            convert.load_torch_file(args.cvae_ckpt), cvae_cfg, device=dev)
    if args.random_init:
        return init_cvae(cvae_cfg, seed=7, device=dev)
    return None


def derive_norm(cha_bvh, window: int, dev):
    """X/Y norm stats from the character clip (demo mode, no dataset):
    windows of ``window`` frames at step 10, full windows only."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    feats = featurize_clip(t(cha_bvh["rotations"]), t(cha_bvh["positions"]),
                           cha_bvh["order"], cha_bvh["names"],
                           cha_bvh["parents"])
    w = window_features(feats, window, 10, padded=False)
    X, Y, root = window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], feats["bone_parents"])
    return compute_norm_stats(X.cpu().numpy(), Y.cpu().numpy(),
                              root.cpu().numpy())


def check_skeletons(src_paths, src_bvhs) -> None:
    """Every clip must share the first clip's joint names and parents."""
    first = src_bvhs[0]
    for p, b in zip(src_paths[1:], src_bvhs[1:]):
        if (list(b["names"]) != list(first["names"])
                or not np.array_equal(np.asarray(b["parents"]),
                                      np.asarray(first["parents"]))):
            raise SystemExit(
                f"{p}: skeleton differs from {src_paths[0]}; all clips in "
                "--src-dir must share one hierarchy (joint names and "
                "parents)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--src", default=None, help="source BVH")
    ap.add_argument("--src-dir", default=None,
                    help="characterize every *.bvh under this directory as "
                         "parallel batched streams; writes one "
                         "Src_/Ours_/CM_ triple per clip")
    ap.add_argument("--cha", required=True, help="character BVH")
    ap.add_argument("--gen-ckpt", default=None,
                    help="generator checkpoint: the reference's .pt, the "
                         "JAX package's .msgpack or the port trainer's "
                         ".ckpt (the last two serve their EMA)")
    ap.add_argument("--cvae-ckpt", default=None,
                    help="CVAE checkpoint: the reference's state dict "
                         "(.pt), the JAX package's .msgpack or the port "
                         "trainer's cvae_*.ckpt")
    ap.add_argument("--cvae-norm", default=None, help="cvae_norm.npz")
    ap.add_argument("--norm", default=None, help="norm.npz (X/Y stats)")
    ap.add_argument("--cnt-norm", default=None, help="cnt_norm.npz")
    ap.add_argument("--out", default="./results")
    ap.add_argument("--random-init", action="store_true",
                    help="run with fresh weights from NumPy seeds "
                         "(smoke/demo mode; not the JAX package's "
                         "PRNGKey(1777) weights)")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic CVAE sampling")
    ap.add_argument("--no-ik", action="store_true")
    ap.add_argument("--seed", type=int, default=1777,
                    help="seed of the torch.Generator of the CVAE noise")
    ap.add_argument("--production", action="store_true",
                    help="serving mode: skip the NN comparison stream "
                         "(CM output = CVAE output)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 generator/CVAE weights and matmuls, bf16 "
                         "operands of the NN score product (f32 pose math)")
    ap.add_argument("--tchunk", type=int, default=0, metavar="FRAMES",
                    help="--src-dir only: keep the featurized inputs on the "
                         "host and upload them in time chunks of this many "
                         "frames (runner.chunked); 0 = the whole batch on "
                         "the device")
    ap.add_argument("--viz", default=None, metavar="FILE.{mp4,gif}",
                    help="--src only: render src/cm/trans/ik side by side "
                         "to a video on the host (matplotlib; .mp4 needs "
                         "ffmpeg, .gif pillow)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU unless 'cpu' is given)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.tchunk and not args.src_dir:
        ap.error("--tchunk applies to the --src-dir batch path")
    if (args.src is None) == (args.src_dir is None):
        ap.error("provide exactly one of --src or --src-dir")
    if args.tchunk < 0:
        ap.error("--tchunk must be >= 0")
    if args.src_dir and args.viz:
        ap.error("--viz is a single-clip option; use it with --src")
    if args.viz:
        try:
            import matplotlib
        except ImportError:
            raise SystemExit("--viz needs the matplotlib package, which is "
                             "not installed here") from None
        matplotlib.use("Agg")
    dev = resolve_device(args.device)

    cfg_dict = get_config(args.config)
    cfg = GeneratorConfig.from_dict(cfg_dict["model"])
    cvae_d = cfg_dict.get("cvae", {})
    cvae_cfg = CVAEConfig(
        output_seq=cfg.num_tokens,
        latent_dim=cvae_d.get("latent_dim", 256),
        depth=cvae_d.get("depth", 2),
        nheads=cvae_d.get("nheads", 4),
        feedforward_dim=cvae_d.get("feedforward_dim", 512))
    rt = cfg_dict.get("runtime", {})
    ik_cfg = rts.IKConfig(enabled=not args.no_ik,
                          **{k: v for k, v in rt.get("ik", {}).items()
                             if k != "enabled"})
    window = int(rt.get("window", 60))
    contact_bones = tuple(rt.get("contact_bones", (5, 24)))
    dt = rt.get("dt", 1.0 / 60.0)

    gen = load_generator(args, cfg, dev)
    cvae = load_cvae(args, cvae_cfg, dev)

    if args.src_dir:
        src_paths = sorted(glob.glob(
            os.path.join(args.src_dir, "**", "*.bvh"), recursive=True))
        if not src_paths:
            raise SystemExit(f"no .bvh files under {args.src_dir}")
    else:
        src_paths = [args.src]
    cha_bvh = bvh.load(args.cha)
    src_bvhs = [bvh.load(p) for p in src_paths]
    check_skeletons(src_paths, src_bvhs)

    if args.norm:
        norm = dict(np.load(args.norm))
    else:
        norm = derive_norm(cha_bvh, window, dev)
        print("note: no --norm given; derived stats from the character clip")

    print("featurizing + encoding the character clip ...")
    cha_feats = rtf.clip_stream_features_device(cha_bvh, gen, norm,
                                                window=window, device=dev)
    if args.cnt_norm:
        cnt_norm = dict(np.load(args.cnt_norm))
    else:
        cnt_norm = rtf.compute_cnt_norm(cha_feats["encoded"],
                                        cha_feats["cnt"])
        print("note: no --cnt-norm given; derived from the character clip")
    cvae_norm = dict(np.load(args.cvae_norm)) if args.cvae_norm else None

    consts = rts.build_consts(norm, cnt_norm, cvae_norm, cha_feats,
                              device=dev)
    parents = np.concatenate([[-1], np.asarray(src_bvhs[0]["parents"]) + 1])

    # --bf16: the character was encoded with the float32 weights, as in
    # the JAX CLI; the sources and the session run on bf16 weights
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.bf16:
        gen = gen.to(torch.bfloat16)
        if cvae is not None:
            cvae = cvae.to(torch.bfloat16)

    ensure_dirs(args.out)
    names = list(src_bvhs[0]["names"])
    cha_name = os.path.basename(args.cha)

    def write_outputs(src_path, o):
        src_name = os.path.basename(src_path)
        stem = src_name[:-4]
        for prefix, pos, rot in (
                ("Src_", "src_pos", "src_rot"),
                ("Ours_", "ik_pos", "ik_rot"),
                ("CM_", "cm_pos", "cm_rot")):
            name = (prefix + src_name if prefix == "Src_"
                    else prefix + stem + "_To_" + cha_name)
            path = os.path.join(args.out, name)
            rtexport.save_characterized_bvh(path, o[pos], o[rot], parents,
                                            names)
            print(f"wrote {path}")

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    run_kw = dict(contact_bones=contact_bones, ik=ik_cfg, dt=dt,
                  deterministic=args.deterministic,
                  compute_cm=not args.production, root_dtype=torch.float64,
                  compute_dtype=compute_dtype)

    if args.src_dir:
        # one featurize+encode pass per distinct clip length, then every
        # clip as a parallel stream of one runner; shorter clips ride
        # edge-padded and their outputs are trimmed back per clip.
        # emit_cnt=False: the runner re-derives cnt from encoded.
        frame0, xs, n_windows, n_groups = rtf.batch_stream_features_ragged(
            src_bvhs, gen, norm, window=window, emit_cnt=False,
            compute_dtype=compute_dtype, device=dev)
        print(f"featurize+encode: {n_groups} group(s) for {len(src_paths)} "
              "clips (one batch per distinct length)")
        print(f"characterizing {len(src_paths)} clips "
              f"({sum(n_windows)} frames) as parallel streams ...")
        runner = rts.make_batch_runner(gen, cvae, consts, parents,
                                       device=dev, **run_kw)
        if args.tchunk:
            out = runner.chunked({k: v.cpu() for k, v in frame0.items()},
                                 {k: v.cpu() for k, v in xs.items()},
                                 generator, tchunk=args.tchunk)
        else:
            out = runner(frame0, xs, generator)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for i, (p, L) in enumerate(zip(src_paths, n_windows)):
            write_outputs(p, {k: v[:L, i] for k, v in out.items()})
        return out

    src_feats = rtf.clip_stream_features_device(
        src_bvhs[0], gen, norm, window=window, compute_dtype=compute_dtype,
        device=dev)
    print(f"characterizing {len(src_feats['encoded'])} frames ...")
    out = rts.characterize_clip(gen, cvae, consts, parents, src_feats,
                                generator=generator, device=dev, **run_kw)
    write_outputs(args.src, out)
    if args.viz:
        from ..viz import animation_plot

        bones = np.asarray(contact_bones)
        animation_plot([[out[f"{s}_pos"], out[f"{s}_rot"], out["contact"],
                         bones, parents]
                        for s in ("src", "cm", "trans", "ik")],
                       save_path=args.viz, show=False)
        print(f"wrote {args.viz}")
    return out


if __name__ == "__main__":
    main()
