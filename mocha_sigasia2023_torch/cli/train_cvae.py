"""CVAE predictor training CLI.

Counterpart of mocha_sigasia2023_tpu/cli/train_cvae.py: reads the
dataset's ``cnt_norm.npz`` and two feature files written by
``collect_features character`` (source and character), trains the
autoregressive predictor with scheduled sampling, writes ``cvae_norm.npz``
(the same keys and values as the JAX CLI's) and checkpoints in the port's
own format, ``cvae_<iteration:06d>.ckpt`` (``{"cvae": state_dict,
"iteration": it}``), every ``--save-every`` iterations and at the end.
It runs on the GPU unless ``--device cpu`` is given.

The host assembles each iteration's batch (an action pick, ~90 MB of
noise, the nearest-neighbour gather) in a prefetch thread one batch ahead
of the device rollout, copying it from pinned memory; metrics are read
once every ``log_every`` iterations.

Run: python -m mocha_sigasia2023_torch.cli.train_cvae \\
         --src-features CVAE_transformer/Neutral_5action_feature.npz \\
         --cha-features CVAE_transformer/Neutral_Princess_5action_feature.npz \\
         --cnt-norm datasets/mocha60/cnt_norm.npz \\
         --out CVAE_transformer/src2cha [--num-iters N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data.dataset import prefetch_batches
from ..device import resolve_device
from ..train.checkpoint import save_checkpoint
from ..train.trainer_cvae import (CVAETrainer, CVAETrainerConfig,
                                  cvae_checkpoint_path)
from ..utils import ensure_dirs, get_config, set_seed
from ..utils.logging import MetricsLogger
from .characterize import DEFAULT_CONFIG


def trainer_config(cfg, batch_size=None) -> CVAETrainerConfig:
    """The trainer's config from a config file's ``cvae:`` section."""
    return CVAETrainerConfig(
        latent_dim=cfg.get("latent_dim", 256),
        depth=cfg.get("depth", 2),
        nheads=cfg.get("nheads", 4),
        feedforward_dim=cfg.get("feedforward_dim", 512),
        dropout=cfg.get("dropout", 0.1),
        rollout_steps=cfg.get("rollout_steps", 10),
        batch_size=batch_size or cfg.get("batch_size", 32),
        lr=cfg.get("lr", 1e-4),
        weight_decay=cfg.get("weight_decay", 1e-4),
        lr_gamma=cfg.get("lr_gamma", 0.99),
        lr_step_every=cfg.get("lr_step_every", 200),
        kl_w=cfg.get("kl_w", 1e-2),
        kl_anneal_start=cfg.get("kl_anneal_start", 0),
        kl_anneal_end=cfg.get("kl_anneal_end", 5000),
        dist_w=cfg.get("dist_w", 0.1),
        condition_dropout=cfg.get("condition_dropout", 0.8),
        teacher_iters=cfg.get("teacher_iters", 10000),
        ramping_iters=cfg.get("ramping_iters", 10000),
        student_iters=cfg.get("student_iters", 20000),
    )


def device_batches(stream, dev):
    """``stream``'s (it, batch) items with each batch's arrays on ``dev``,
    copied from pinned memory without blocking the host on a GPU."""
    pin = dev.type == "cuda"

    def place(item):
        it, b = item
        if b is None:
            return it, None
        ts = (torch.from_numpy(a) for a in b)
        return it, tuple(t.pin_memory().to(dev, non_blocking=True) if pin
                         else t for t in ts)

    return prefetch_batches(stream, place=place)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--src-features", required=True)
    ap.add_argument("--cha-features", required=True)
    ap.add_argument("--cnt-norm", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--target-actions", type=int, nargs="*", default=None,
                    help="action label ids; default: all in the source set")
    ap.add_argument("--num-iters", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--save-every", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=1777)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    config = get_config(args.config)
    tc = trainer_config(config.get("cvae", {}), args.batch_size)
    set_seed(args.seed)
    cnt_norm = dict(np.load(args.cnt_norm))
    src = dict(np.load(args.src_features))
    cha = dict(np.load(args.cha_features))
    actions = args.target_actions
    if actions is None:
        actions = sorted(set(int(a) for a in src["action_label"]))

    trainer = CVAETrainer(
        tc,
        src_cnt=src["cnt"], src_action=src["action_label"],
        src_range_starts=src["range_starts"],
        src_range_stops=src["range_stops"],
        cha_cnt=cha["cnt"], cha_encoded=cha["encoded"],
        cha_action=cha["action_label"],
        cha_range_starts=cha["range_starts"],
        cha_range_stops=cha["range_stops"],
        cnt_mean=cnt_norm["mean"], cnt_std=cnt_norm["std"],
        target_actions=actions, seed=args.seed, device=dev)

    ensure_dirs(args.out)
    norm_path = os.path.join(args.out, "cvae_norm.npz")
    if not os.path.exists(norm_path):
        np.savez_compressed(norm_path, **trainer.norm_artifacts())
        print(f"wrote {norm_path}")

    writer = MetricsLogger(os.path.join(args.out, "log"))
    num_iters = args.num_iters or tc.num_iters
    log_every = int(config.get("log_every", 5))
    pending = []   # (iteration, device metrics) awaiting one fetch
    metrics = None

    def flush_metrics():
        nonlocal metrics
        if not pending:
            return
        vals = torch.stack([m for _, m in pending]).cpu().numpy()
        for (i, _), v in zip(pending, vals):
            metrics = trainer.metrics_dict(i, v)
            writer.add_scalars(metrics, i)
        pending.clear()

    def save(iteration):
        path = cvae_checkpoint_path(args.out, iteration)
        save_checkpoint(path, trainer.state(iteration))
        print(f"\nsaved {path}")

    print(f"training {num_iters} iterations on {dev} (prefetched batches, "
          f"metrics read every {log_every} iterations)")
    for it, batch in device_batches(trainer.batch_stream(num_iters), dev):
        if batch is None:
            continue
        pending.append((it, trainer.step_placed(it, batch)))
        if (it + 1) % log_every == 0:
            flush_metrics()
        if (it + 1) % log_every == 0 and metrics is not None:
            sys.stdout.write(
                "\riter %7d cnt %.3f enc %.3f kl %.3f dist %.3f" % (
                    it + 1, metrics["cvae/cnt_loss"],
                    metrics["cvae/encoded_loss"], metrics["cvae/kl_loss"],
                    metrics["cvae/dist_loss"]))
            sys.stdout.flush()
        if (it + 1) % args.save_every == 0:
            flush_metrics()
            save(it + 1)
    flush_metrics()
    save(num_iters)
    writer.close()
    return trainer


if __name__ == "__main__":
    main()
