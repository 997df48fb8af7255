"""Windowed features + normalization stats (serving subset).

Counterpart of mocha_sigasia2023_tpu/data/dataset.py:31-165: the
finite-difference window velocities, the character-space X / parent-local
Y window features, and the per-joint-channel norm stats.  Feature layout
per joint (15 channels): [pos(3), xform_xy(6), vel(3), ang(3)].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kinematics import quat
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
