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

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
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
