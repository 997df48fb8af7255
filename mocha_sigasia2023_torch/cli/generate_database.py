"""Build the packed motion database from a directory of BVH files.

Counterpart of mocha_sigasia2023_tpu/cli/generate_database.py: per clip x
{original, mirrored}: parse -> featurize on the device (mirroring, root-bone
synthesis, velocities, contacts at 0.2 m/s) -> append; style/action labels
parsed from the file names against the dataset vocabularies; packed to
database.bin.  It runs on the GPU unless ``--device cpu`` is given.

Run: python -m mocha_sigasia2023_torch.cli.generate_database \\
         --bvh-dir ./bvh --out ./datasets/mocha60 \\
         [--dataset-config configs/dataset.yaml] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..data.preprocess import ARRAY_KEYS, featurize_clip
from ..device import resolve_device
from ..io import bvh
from ..io.database import save_database
from ..utils import ensure_dirs, get_config

DEFAULT_DATASET_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "dataset.yaml")


def label_from_name(stem: str, vocab) -> int:
    """Index of the first vocabulary entry contained in the file name."""
    for i, name in enumerate(vocab):
        if name in stem:
            return i
    raise ValueError(f"no label in {stem!r}")


@torch.no_grad()
def build_database(bvh_files, style_names, action_names, *,
                   contact_velocity_threshold=0.2, mirror=True, fps=60.0,
                   device=None):
    """Featurize every clip (and its mirror) on ``device`` into a database
    dict, one range per clip and variant, in file order."""
    dev = resolve_device(device)
    blocks = {k: [] for k in ARRAY_KEYS}
    starts, stops, styles, actions = [], [], [], []
    parents = None
    variants = [False, True] if mirror else [False]
    for i, path in enumerate(bvh_files):
        stem = Path(path).stem
        style = label_from_name(stem, style_names)
        action = label_from_name(stem, action_names)
        data = bvh.load(str(path))
        rot = torch.as_tensor(np.asarray(data["rotations"], np.float32),
                              device=dev)
        pos = torch.as_tensor(np.asarray(data["positions"], np.float32),
                              device=dev)
        for mirrored in variants:
            print(f"[{i + 1}/{len(bvh_files)}] {stem}"
                  f"{'_Mirrored' if mirrored else ''}")
            f = featurize_clip(
                rot, pos, data["order"], data["names"], data["parents"],
                mirror=mirrored,
                contact_velocity_threshold=contact_velocity_threshold,
                fps=fps)
            for k in ARRAY_KEYS:
                blocks[k].append(f[k].cpu().numpy())
            off = stops[-1] if stops else 0
            starts.append(off)
            stops.append(off + len(blocks["positions"][-1]))
            styles.append(style)
            actions.append(action)
            parents = f["bone_parents"]
    cat = {k: np.concatenate(v) for k, v in blocks.items()}
    return {
        "bone_positions": cat["positions"].astype(np.float32),
        "bone_velocities": cat["velocities"].astype(np.float32),
        "bone_rotations": cat["rotations"].astype(np.float32),
        "bone_angular_velocities":
            cat["angular_velocities"].astype(np.float32),
        "bone_parents": np.asarray(parents, np.int32),
        "range_starts": np.asarray(starts, np.int32),
        "range_stops": np.asarray(stops, np.int32),
        "style_labels": np.asarray(styles, np.int32),
        "action_labels": np.asarray(actions, np.int32),
        "contact_states": cat["contacts"].astype(np.uint8),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bvh-dir", required=True)
    ap.add_argument("--out", required=True, help="output dataset directory")
    ap.add_argument("--dataset-config", default=DEFAULT_DATASET_CONFIG)
    ap.add_argument("--contact-threshold", type=float, default=0.2)
    ap.add_argument("--no-mirror", action="store_true")
    ap.add_argument("--name", default="database.bin")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU unless 'cpu' is given)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.dataset_config)
    files = sorted(
        p for p in Path(args.bvh_dir).rglob("*.bvh") if p.name != "rest.bvh")
    if not files:
        raise SystemExit(f"no .bvh files under {args.bvh_dir}")
    db = build_database(
        files, cfg["mocha_style_names"], cfg["mocha_action_names"],
        contact_velocity_threshold=args.contact_threshold,
        mirror=not args.no_mirror, device=dev)
    ensure_dirs(args.out)
    out_path = os.path.join(args.out, args.name)
    save_database(out_path, db)
    print(f"wrote {out_path}: {db['bone_positions'].shape[0]} frames, "
          f"{len(db['range_starts'])} clips")
    return db


if __name__ == "__main__":
    main()
