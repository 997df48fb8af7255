"""Generator training CLI.

Counterpart of mocha_sigasia2023_tpu/cli/train.py: a config snapshot into
``<name>/info/``, two independently shuffled window streams (source and
character, seeds ``seed`` and ``seed + 10_000`` per epoch), the epoch loop
with a checkpoint every ``save_every`` epochs and at the end, and JSONL
(and TensorBoard, if it imports) scalars every ``log_every`` steps.  It
runs on the GPU unless ``--device cpu`` is given.

``--data-parallel K`` trains on K ranks, one process and one device each
(default: the largest divisor of the batch size that is at most the
number of visible CUDA devices, as the JAX CLI sizes its data axis; 1 on
the CPU).  The CLI starts the K processes itself; under ``torchrun`` it
is one of them (``WORLD_SIZE`` ranks).  Every rank iterates the same
global batches from the same seeds and puts its block of each on its
device; rank 0 writes ``info/``, the metrics and the checkpoints.  The
backend is ``nccl`` when each rank has a card of its own, else ``gloo``
(``--backend`` to choose; ``nccl`` needs ``--device cuda`` and a card a
rank).  K = 1 without ``--backend`` trains in this process, without a
process group.

Run: python -m mocha_sigasia2023_torch.cli.train --config configs/config.yaml \\
         [--data-dir DIR] [--max-epochs N] [--batch-size B] [--resume CKPT] \\
         [--data-parallel K] [--backend nccl|gloo] [--device cpu]
     torchrun --nproc-per-node K -m mocha_sigasia2023_torch.cli.train ...
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
from ..parallel import distributed
from ..parallel.mesh import data_parallel_size, make_mesh, shard_batch
from ..train.trainer import GeneratorTrainer
from ..utils import describe_params, ensure_dirs, get_config, set_seed
from ..utils.logging import MetricsLogger
from .characterize import DEFAULT_CONFIG

# the fields a training step reads
BATCH_KEYS = ("X", "Y")


def device_batches(batches, dev, mesh=None):
    """This rank's block (``parallel.shard_batch``; all of it without a
    mesh) of each batch's X and Y on ``dev``: copied from pinned memory
    without blocking the host when ``dev`` is a GPU."""
    pin = dev.type == "cuda"

    def place(b):
        out = {}
        for k in BATCH_KEYS:
            t = torch.from_numpy(shard_batch(mesh, b[k]))
            out[k] = t.pin_memory().to(dev, non_blocking=True) if pin \
                else t.to(dev)
        return out

    return prefetch_batches(batches, place=place)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="ranks to train on (default: the largest divisor "
                         "of the batch size at most the visible CUDA "
                         "devices; 1 on the CPU)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend (default: nccl when each "
                         "rank has a card of its own, else gloo)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume: the port's .ckpt or the "
                         "JAX package's .msgpack (its AdamW state too)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def read_config(args) -> dict:
    config = get_config(args.config)
    if args.data_dir:
        config["data_dir"] = args.data_dir
    if args.max_epochs is not None:
        config["max_epochs"] = args.max_epochs
    if args.batch_size is not None:
        config["batch_size"] = args.batch_size
    return config


def main(argv=None):
    """Train; returns this process's trainer (None when the ranks ran in
    processes of their own)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.backend == "nccl" and dev.type != "cuda":
        raise SystemExit(f"--backend nccl reduces CUDA tensors; --device "
                         f"{args.device} ranks take --backend gloo")
    config = read_config(args)
    batch_size = int(config["batch_size"])

    if "WORLD_SIZE" in os.environ:      # one rank of a torchrun launch
        world = int(os.environ["WORLD_SIZE"])
        check_ranks(args, world, batch_size)
        rank_dev = distributed.initialize_multihost(
            backend=args.backend, device=args.device)
        try:
            return train(args, config, rank_dev,
                         make_mesh(device_type=rank_dev.type))
        finally:
            distributed.shutdown()

    k = args.data_parallel
    if k is None:
        k = data_parallel_size(batch_size, torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
    check_ranks(args, k, batch_size)
    if k == 1 and args.backend is None:
        return train(args, config, dev, None)
    distributed.spawn(_rank_main, k, args=(args, config),
                      backend=args.backend, device=args.device)
    return None


def check_ranks(args, k: int, batch_size: int) -> None:
    if args.data_parallel not in (None, k):
        raise SystemExit(f"--data-parallel {args.data_parallel} under a "
                         f"launch of {k} ranks")
    if k < 1 or batch_size % k:
        raise SystemExit(f"--data-parallel {k}: the ranks must split the "
                         f"batch of {batch_size} evenly")


def _rank_main(rank, dev, args, config):
    train(args, config, dev, make_mesh(device_type=dev.type))


def train(args, config, dev, mesh):
    """The training loop on ``dev``: alone (``mesh`` None) or as one rank
    of ``mesh``'s data axis."""
    primary = distributed.is_primary_host()

    def say(msg):
        if primary:
            print(msg)

    main_dir = os.path.join(".", config["name"])
    model_dir = os.path.join(main_dir, "pth")
    tb_dir = os.path.join(main_dir, "log")
    info_dir = os.path.join(main_dir, "info")
    if primary:
        ensure_dirs([main_dir, model_dir, tb_dir, info_dir])
        shutil.copy(args.config, os.path.join(info_dir, "config.yaml"))

    seed = int(config.get("manualSeed", 1777))
    set_seed(seed)

    say("loading dataset ...")
    dataset = MotionDataset(config["data_dir"], "train", device=dev)
    norm = {k: torch.as_tensor(v, device=dev)
            for k, v in dataset.norm.items()}
    batch_size = int(config["batch_size"])
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    say(f"{len(dataset)} windows, {steps_per_epoch} steps/epoch")
    if mesh is not None:
        say(f"mesh: data={mesh.shape[0]} model={mesh.shape[1]} "
            f"({torch.distributed.get_backend()})")
    trainer = GeneratorTrainer(config, steps_per_epoch, seed=seed,
                               device=dev, mesh=mesh)

    if primary:   # network description and parameter counts
        with open(os.path.join(info_dir, "info-network"), "w") as f:
            f.write(describe_params(trainer.gen, "Generator") + "\n\n")
            f.write(describe_params(trainer.prj, "Projector") + "\n")

    start_epoch = 0
    if args.resume:
        start_epoch = trainer.load(args.resume, resume=True)
        say(f"resumed from {args.resume} (epoch {start_epoch})")

    writer = MetricsLogger(os.path.join(tb_dir, "train")) if primary \
        else None
    log_every = int(config.get("log_every", 5))
    save_every = int(config.get("save_every", 25))
    key = torch.Generator().manual_seed(seed)

    for epoch in range(start_epoch, int(config["max_epochs"])):
        t0 = time.time()
        src_stream = device_batches(iterate_batches(
            dataset, batch_size, shuffle=True, seed=seed, epoch=epoch), dev,
            mesh)
        cha_stream = device_batches(iterate_batches(
            dataset, batch_size, shuffle=True, seed=seed + 10_000,
            epoch=epoch), dev, mesh)
        for it, (bs, bc) in enumerate(zip(src_stream, cha_stream)):
            key, sub = split(key, 2)
            metrics = trainer.train_step(bs, bc, norm, sub)
            if writer is not None and (it + 1) % log_every == 0:
                step = epoch * steps_per_epoch + it
                writer.add_scalars(
                    {k: float(v) for k, v in metrics.items()}, step)
        loss = float(metrics["gen/loss_total"])
        say(f"epoch {epoch + 1}/{config['max_epochs']} "
            f"loss_total={loss:.3f} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % save_every == 0:
            path = trainer.save(model_dir, epoch + 1)
            say(f"saved {path}")
    path = trainer.save(model_dir, int(config["max_epochs"]))
    say(f"saved {path}")
    if writer is not None:
        writer.close()
    return trainer


if __name__ == "__main__":
    main()
