"""The port trainer's checkpoints: one ``torch.save`` file, written
atomically, and latest-checkpoint discovery.

Counterpart of mocha_sigasia2023_tpu/train/checkpoint.py, in the port's
own format: ``gen_<epoch>.ckpt`` holds the generator, projector and EMA
state dicts, the optimizer state and the step.  The suffix tells these
files apart from the reference's ``.pt`` checkpoints and the JAX
package's ``.msgpack`` ones.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

SUFFIX = ".ckpt"


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to a temporary file beside ``path``, then rename it
    over ``path``: a reader never sees half a file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's contents, read on the CPU (tensors, containers and
    numbers only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_path(model_dir: str, epoch: int, prefix: str = "gen") -> str:
    return os.path.join(model_dir, f"{prefix}_{epoch:03d}{SUFFIX}")


def latest_checkpoint(model_dir: str, prefix: str = "gen") -> Optional[str]:
    """The lexicographically last of the port's checkpoints in
    ``model_dir``, or None."""
    if not os.path.isdir(model_dir):
        return None
    files = [f for f in os.listdir(model_dir)
             if f.startswith(prefix) and f.endswith(SUFFIX)]
    return os.path.join(model_dir, sorted(files)[-1]) if files else None


def epoch_from_path(path: str) -> int:
    """The epoch in a checkpoint's file name (0 if it has none)."""
    m = re.search(r"_(\d+)\.(?:ckpt|msgpack|pt)$", path)
    return int(m.group(1)) if m else 0
