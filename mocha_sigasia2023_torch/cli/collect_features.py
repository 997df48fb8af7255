"""Dataset feature exports for the CVAE stage.

Counterpart of mocha_sigasia2023_tpu/cli/collect_features.py.  Two
subcommands:
  * cnt-norm  — dataset-wide context-feature statistics -> cnt_norm.npz
                (windows every 20 frames);
  * character — per-character sliding-window encoded/cnt features ->
                <name>_feature.npz (windows every frame).
Both read ``database.bin`` and ``norm.npz`` from ``--data-dir`` and run the
generator's encoder on the GPU unless ``--device cpu`` is given.  Weights:
a generator checkpoint (``--gen-ckpt``: a reference ``.pt``, a JAX package
``.msgpack`` or a port ``.ckpt``) or fresh weights from a NumPy seed
(``--random-init``).

Run:
  python -m mocha_sigasia2023_torch.cli.collect_features cnt-norm \\
      --data-dir datasets/mocha60 --gen-ckpt model_ours/pth/gen_125.pt

  python -m mocha_sigasia2023_torch.cli.collect_features character \\
      --data-dir datasets/mocha60 --gen-ckpt ... \\
      --styles 17 --actions 3 4 6 7 11 --out CVAE_transformer/princess_feature.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..io.database import load_database
from ..models import GeneratorConfig
from ..runtime import features as rtf
from ..utils import get_config
from .characterize import DEFAULT_CONFIG, load_generator


def _common(ap):
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--gen-ckpt", default=None,
                    help="generator checkpoint: the reference's .pt, the "
                         "JAX package's .msgpack or the port trainer's "
                         ".ckpt (the last two serve their EMA)")
    ap.add_argument("--random-init", action="store_true",
                    help="fresh weights from a NumPy seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU unless 'cpu' is given)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _common(sub.add_parser("cnt-norm"))
    ap_ch = sub.add_parser("character")
    _common(ap_ch)
    ap_ch.add_argument("--styles", type=int, nargs="+", required=True)
    ap_ch.add_argument("--actions", type=int, nargs="+", required=True)
    ap_ch.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = GeneratorConfig.from_dict(get_config(args.config)["model"])
    gen = load_generator(args, cfg, dev)
    db = load_database(os.path.join(args.data_dir, "database.bin"))
    norm = dict(np.load(os.path.join(args.data_dir, "norm.npz")))

    if args.cmd == "cnt-norm":
        encoded, cnt, _, _ = rtf.encode_database(db, gen, norm, window=60,
                                                 step=20, device=dev)
        stats = rtf.compute_cnt_norm(encoded, cnt)
        out = os.path.join(args.data_dir, "cnt_norm.npz")
        np.savez_compressed(out, mean=stats["mean"].cpu().numpy(),
                            std=stats["std"].cpu().numpy())
        print(f"wrote {out} over {len(cnt)} windows")
        return stats
    feats = rtf.collect_character_features(
        db, gen, norm, style_labels=args.styles, action_labels=args.actions,
        device=dev)
    np.savez_compressed(args.out, **feats)
    print(f"wrote {args.out}: {feats['encoded'].shape[0]} windows, "
          f"{len(feats['range_starts'])} clips")
    return feats


if __name__ == "__main__":
    main()
