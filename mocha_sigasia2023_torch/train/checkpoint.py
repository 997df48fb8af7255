"""The port trainer's checkpoints: one ``torch.save`` file, written
atomically, and latest-checkpoint discovery; and the JAX package's orbax
checkpoint directories, read and written.

Counterpart of mocha_sigasia2023_tpu/train/checkpoint.py.  The port's own
format: ``gen_<epoch>.ckpt`` holds the generator, projector and EMA
state dicts, the optimizer state and the step.  The suffix tells these
files apart from the reference's ``.pt`` checkpoints and the JAX
package's ``.msgpack`` ones.  ``save_checkpoint_orbax`` /
``load_checkpoint_orbax`` read and write the directories that the JAX
package's functions of those names do (``io/orbax.py``), and
``restore_like`` gives a loaded tree a template's containers.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from ..io import orbax
from ..io.msgpack import is_index_map

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


def restore_like(template, state):
    """``state`` (nested dicts of arrays, lists kept or keyed "0".."n-1",
    as the msgpack and orbax readers return them) in ``template``'s
    containers: its dicts, lists, tuples and NamedTuples, as flax's
    ``from_state_dict`` rebuilds them.  Leaves come from ``state``."""
    def items(node, n, where):
        if isinstance(node, (list, tuple)):
            values = list(node)
        elif isinstance(node, dict) and (is_index_map(node) or not node):
            values = [node[str(i)] for i in range(len(node))]
        else:
            raise ValueError(f"restore_like: {where or 'the root'} holds "
                             f"no {n} items")
        if len(values) != n:
            raise ValueError(f"restore_like: {len(values)} items at "
                             f"{where or 'the root'}, {n} in the template")
        return values

    def walk(t, s, where):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            if not isinstance(s, dict) or set(s) != set(t._fields):
                raise ValueError(f"restore_like: fields {sorted(t._fields)} "
                                 f"wanted at {where or 'the root'}")
            return type(t)(**{f: walk(getattr(t, f), s[f], f"{where}/{f}")
                              for f in t._fields})
        if isinstance(t, dict):
            if not isinstance(s, dict) or set(s) != set(map(str, t)):
                raise ValueError(f"restore_like: keys {sorted(map(str, t))} "
                                 f"wanted at {where or 'the root'}")
            return {k: walk(v, s[str(k)], f"{where}/{k}")
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v, x, f"{where}/{i}") for i, (v, x) in
                   enumerate(zip(t, items(s, len(t), where)))]
            return out if isinstance(t, list) else tuple(out)
        return s

    return walk(template, state, "")


def save_checkpoint_orbax(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` as an orbax checkpoint directory that the JAX
    package's ``load_checkpoint_orbax`` reads: under a temporary name
    beside ``path``, then renamed over it (an existing one is replaced)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    orbax.write_tree(tmp, state)
    if os.path.exists(path):
        old = f"{path}.old.{os.getpid()}"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)


def load_checkpoint_orbax(path: str, template=None):
    """An orbax checkpoint directory as ``io/msgpack.read_msgpack`` returns
    the same state (maps keyed "0".."n-1" as lists), or in ``template``'s
    containers."""
    state = orbax.read_tree(os.path.abspath(path))
    return state if template is None else restore_like(template, state)
