"""Windowed features, normalization stats and the windowed dataset.

Counterpart of mocha_sigasia2023_tpu/data/dataset.py:31-288: the
finite-difference window velocities, the character-space X / parent-local
Y window features (computed on the device in chunks of windows), the
per-joint-channel norm stats, the database's windows and labels
(``database_window_features``, mocha_sigasia2023_tpu/runtime/
features.py:522-544, shared by ``MotionDataset`` and the feature exports),
``MotionDataset`` over a ``database.bin`` (which writes ``norm.npz``
beside it), ``iterate_batches`` and ``prefetch_batches``.  Feature
layout per joint (15 channels): [pos(3), xform_xy(6), vel(3), ang(3)].
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..io.database import load_database
from ..kinematics import quat
from .windows import full_window_indices
# the window velocities are the clip's central differences, taken along
# the window axis
from .preprocess import central_angular_velocity as window_ang
from .preprocess import central_velocity as window_vel


def pin_last(a):
    """Every frame's root row (joint 0) set to the window's last frame."""
    last = a[:, -1:, 0:1]
    a = a.clone()
    a[:, :, 0:1] = last
    return a


def window_xy_features(Yrot, Ypos, Yvel, Yang, parents):
    """(B, T, J, .) windows of parent-local pose -> X (B,T,J,15)
    character-space features relative to the window-last root, Y
    (B,T,J,15) parent-local features with re-derived velocities, and root
    (B,T,6) body-frame root velocities."""
    Yrvel = quat.inv_mul_vec(Yrot[:, :, 0], Yvel[:, :, 0])
    Yrang = quat.inv_mul_vec(Yrot[:, :, 0], Yang[:, :, 0])

    Grot, Gpos, Gvel, Gang = quat.fk_vel(Yrot, Ypos, Yvel, Yang, parents)
    Grot, Gpos = pin_last(Grot), pin_last(Gpos)
    Gvel, Gang = pin_last(Gvel), pin_last(Gang)

    root_rot = Grot[:, :, 0:1]
    Xpos = quat.inv_mul_vec(root_rot, Gpos - Gpos[:, :, 0:1])
    Xrot = quat.inv_mul(root_rot, Grot)
    Xvel = quat.inv_mul_vec(root_rot, Gvel)
    Xang = quat.inv_mul_vec(root_rot, Gang)

    Yrot2, Ypos2 = quat.ik(Xrot, Xpos, parents)
    b, t, j = Xpos.shape[:3]
    X = torch.cat([Xpos, quat.to_xform_xy(Xrot).reshape(b, t, j, 6), Xvel,
                   Xang], dim=-1)
    Y = torch.cat([Ypos2, quat.to_xform_xy(Yrot2).reshape(b, t, j, 6),
                   window_vel(Ypos2), window_ang(Yrot2)], dim=-1)
    root = torch.cat([Yrvel, Yrang], dim=-1)
    return X, Y, root


@torch.no_grad()
def compute_window_features(Yrot, Ypos, Yvel, Yang, parents, batch=2048,
                            device=None):
    """:func:`window_xy_features` over host arrays of windows, ``batch``
    windows at a time on ``device``; returns host (X, Y, root)."""
    dev = resolve_device(device)
    outs = []
    for i in range(0, len(Yrot), batch):
        chunk = [torch.as_tensor(np.ascontiguousarray(a[i:i + batch]),
                                 dtype=torch.float32, device=dev)
                 for a in (Yrot, Ypos, Yvel, Yang)]
        outs.append([o.cpu().numpy()
                     for o in window_xy_features(*chunk, parents)])
    return tuple(np.concatenate([o[k] for o in outs]) for k in range(3))


def database_window_features(db: Dict, *, window: int = 60, step: int = 20,
                             clip_filter=None):
    """Full windows of ``window`` frames every ``step`` frames within each
    range of a loaded database, with their labels: (row indices (W,
    window), style labels, action labels).  ``clip_filter(style, action)
    -> bool`` restricts the ranges."""
    starts, stops = db["range_starts"], db["range_stops"]
    idx_all, styles, actions = [], [], []
    for i in range(len(starts)):
        if clip_filter is not None and not clip_filter(
                int(db["style_labels"][i]), int(db["action_labels"][i])):
            continue
        idx = full_window_indices(int(stops[i] - starts[i]), window, step) \
            + int(starts[i])
        idx_all.append(idx)
        styles += [int(db["style_labels"][i])] * len(idx)
        actions += [int(db["action_labels"][i])] * len(idx)
    if not idx_all:
        raise ValueError("clip_filter selected no clips")
    return (np.concatenate(idx_all), np.asarray(styles, np.int32),
            np.asarray(actions, np.int32))


def compute_norm_stats(X, Y, root) -> Dict[str, np.ndarray]:
    """Per-joint-channel mean/std over (windows, frames) of host arrays;
    std floored with +1e-6."""
    def ms(a):
        a = np.asarray(a)
        return (a.mean(axis=(0, 1)).astype(np.float32),
                a.std(axis=(0, 1)).astype(np.float32))

    X_mean, X_std = ms(X)
    Y_mean, Y_std = ms(Y)
    root_mean, root_std = ms(root)
    return {"X_mean": X_mean, "X_std": X_std + 1e-6,
            "Y_mean": Y_mean, "Y_std": Y_std + 1e-6,
            "root_mean": root_mean, "root_std": root_std}


class MotionDataset:
    """Windowed motion dataset over a packed ``database.bin``: windows of
    ``window`` frames every ``window_step`` frames within each range (short
    windows dropped), their X / Y / root features, contacts and labels as
    float32 / int32 host arrays.  The norm stats are written to
    ``norm.npz`` next to the database unless it exists, and read back.
    The features are computed on ``device`` (cuda unless given)."""

    def __init__(self, data_dir: str, phase: str = "train",
                 window: int = 60, window_step: int = 20, device=None):
        name = "database_test.bin" if phase == "test" else "database.bin"
        db = load_database(os.path.join(data_dir, name))
        norm_path = os.path.join(data_dir, "norm.npz")

        parents = db["bone_parents"]
        idx_all, labels, actions = database_window_features(
            db, window=window, step=window_step)

        X, Y, root = compute_window_features(
            db["bone_rotations"][idx_all], db["bone_positions"][idx_all],
            db["bone_velocities"][idx_all],
            db["bone_angular_velocities"][idx_all], parents, device=device)
        if not os.path.exists(norm_path):
            # renamed into place: the ranks of a data-parallel run each
            # build the dataset, and none may read half a file
            tmp = f"{norm_path}.tmp.{os.getpid()}.npz"
            np.savez_compressed(tmp, **compute_norm_stats(X, Y, root))
            os.replace(tmp, norm_path)

        self.X = X.astype(np.float32)
        self.Y = Y.astype(np.float32)
        self.root = root.astype(np.float32)
        self.contact = db["contact_states"].astype(np.float32)[idx_all]
        self.label = labels
        self.action = actions
        self.parents = np.asarray(parents)
        self.norm = dict(np.load(norm_path))

    def __len__(self):
        return len(self.X)

    def __getitem__(self, index):
        return {"X": self.X[index], "Y": self.Y[index],
                "root": self.root[index], "contact": self.contact[index],
                "label": self.label[index]}


def iterate_batches(dataset: MotionDataset, batch_size: int, *,
                    shuffle: bool = True, drop_last: bool = True,
                    seed: int = 0, epoch: int = 0) -> Iterator[Dict]:
    """Host batches of ``dataset`` items as stacked arrays, shuffled with
    ``RandomState(seed + epoch)``; ``drop_last`` drops a short tail."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        yield dataset[order[i:i + batch_size]]


def prefetch_batches(batches: Iterator[Dict], *, place=None,
                     depth: int = 2) -> Iterator[Dict]:
    """Iterate ``batches`` with a background thread gathering (and, through
    ``place``, placing) up to ``depth`` batches ahead, so that host batch
    assembly and the host-to-device copy overlap the device step.  A
    ``place`` such as ``lambda b: {k: torch.from_numpy(v).pin_memory().to(
    dev, non_blocking=True) for k, v in b.items()}`` copies from pinned
    memory.  An exception in the worker is raised again in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    end = object()

    def worker():
        try:
            for b in batches:
                q.put(place(b) if place is not None else b)
        except BaseException as e:  # raised again on the consumer's side
            q.put(e)
            return
        q.put(end)

    t = threading.Thread(target=worker, daemon=True,
                         name="mocha-batch-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
