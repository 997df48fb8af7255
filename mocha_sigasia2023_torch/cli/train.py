"""Generator training CLI.

Counterpart of mocha_sigasia2023_tpu/cli/train.py: a config snapshot into
``<name>/info/``, two independently shuffled window streams (source and
character, seeds ``seed`` and ``seed + 10_000`` per epoch), the epoch loop
with a checkpoint every ``save_every`` epochs and at the end, and JSONL
(and TensorBoard, if it imports) scalars every ``log_every`` steps.  It
runs on the GPU unless ``--device cpu`` is given, on one device.

Run: python -m mocha_sigasia2023_torch.cli.train --config configs/config.yaml \\
         [--data-dir DIR] [--max-epochs N] [--batch-size B] [--resume CKPT] \\
         [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import torch

from ..data.dataset import MotionDataset, iterate_batches, prefetch_batches
from ..device import resolve_device
from ..models.layers import split
from ..train.trainer import GeneratorTrainer
from ..utils import describe_params, ensure_dirs, get_config, set_seed
from ..utils.logging import MetricsLogger
from .characterize import DEFAULT_CONFIG

# the fields a training step reads
BATCH_KEYS = ("X", "Y")


def device_batches(batches, dev):
    """Each batch's X and Y on ``dev``: copied from pinned memory without
    blocking the host when ``dev`` is a GPU."""
    pin = dev.type == "cuda"

    def place(b):
        out = {}
        for k in BATCH_KEYS:
            t = torch.from_numpy(b[k])
            out[k] = t.pin_memory().to(dev, non_blocking=True) if pin \
                else t.to(dev)
        return out

    return prefetch_batches(batches, place=place)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="devices to train on; the port trains on one")
    ap.add_argument("--resume", default=None, help="checkpoint to resume")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.data_parallel not in (None, 1):
        raise SystemExit(
            f"--data-parallel {args.data_parallel}: the port trains on one "
            "device; data parallelism waits for its torch.distributed port "
            "(ROADMAP.md R9)")
    dev = resolve_device(args.device)

    config = get_config(args.config)
    if args.data_dir:
        config["data_dir"] = args.data_dir
    if args.max_epochs is not None:
        config["max_epochs"] = args.max_epochs
    if args.batch_size is not None:
        config["batch_size"] = args.batch_size

    main_dir = os.path.join(".", config["name"])
    model_dir = os.path.join(main_dir, "pth")
    tb_dir = os.path.join(main_dir, "log")
    info_dir = os.path.join(main_dir, "info")
    ensure_dirs([main_dir, model_dir, tb_dir, info_dir])
    shutil.copy(args.config, os.path.join(info_dir, "config.yaml"))

    seed = int(config.get("manualSeed", 1777))
    set_seed(seed)

    print("loading dataset ...")
    dataset = MotionDataset(config["data_dir"], "train", device=dev)
    norm = {k: torch.as_tensor(v, device=dev)
            for k, v in dataset.norm.items()}
    batch_size = int(config["batch_size"])
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    print(f"{len(dataset)} windows, {steps_per_epoch} steps/epoch")
    trainer = GeneratorTrainer(config, steps_per_epoch, seed=seed,
                               device=dev)

    # network description and parameter counts
    with open(os.path.join(info_dir, "info-network"), "w") as f:
        f.write(describe_params(trainer.gen, "Generator") + "\n\n")
        f.write(describe_params(trainer.prj, "Projector") + "\n")

    start_epoch = 0
    if args.resume:
        start_epoch = trainer.load(args.resume, resume=True)
        print(f"resumed from {args.resume} (epoch {start_epoch})")

    writer = MetricsLogger(os.path.join(tb_dir, "train"))
    log_every = int(config.get("log_every", 5))
    save_every = int(config.get("save_every", 25))
    key = torch.Generator().manual_seed(seed)

    for epoch in range(start_epoch, int(config["max_epochs"])):
        t0 = time.time()
        src_stream = device_batches(iterate_batches(
            dataset, batch_size, shuffle=True, seed=seed, epoch=epoch), dev)
        cha_stream = device_batches(iterate_batches(
            dataset, batch_size, shuffle=True, seed=seed + 10_000,
            epoch=epoch), dev)
        for it, (bs, bc) in enumerate(zip(src_stream, cha_stream)):
            key, sub = split(key, 2)
            metrics = trainer.train_step(bs, bc, norm, sub)
            if (it + 1) % log_every == 0:
                step = epoch * steps_per_epoch + it
                writer.add_scalars(
                    {k: float(v) for k, v in metrics.items()}, step)
        loss = float(metrics["gen/loss_total"])
        print(f"epoch {epoch + 1}/{config['max_epochs']} "
              f"loss_total={loss:.3f} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % save_every == 0:
            path = trainer.save(model_dir, epoch + 1)
            print(f"saved {path}")
    path = trainer.save(model_dir, int(config["max_epochs"]))
    print(f"saved {path}")
    writer.close()
    return trainer


if __name__ == "__main__":
    main()
