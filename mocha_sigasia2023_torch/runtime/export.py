"""Characterized-motion export: re-rooting + BVH writing.

Counterpart of mocha_sigasia2023_tpu/runtime/export.py: drop the
synthesized root bone, move the hips to world space by FK, and save an
Euler-degree BVH.  Host arrays in, a file out; FK runs on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..io import bvh
from ..kinematics import quat


def reroot_to_hips(Ypos: np.ndarray, Yrot: np.ndarray, parents) -> tuple:
    """(T, J, .) root-augmented pose -> (T, J-1, .) with world-space hips."""
    Ypos, Yrot = np.asarray(Ypos), np.asarray(Yrot)
    # float64 root streams can emit mixed float64/float32 pose arrays: FK
    # runs in the wider of the two, and the rows keep their own dtype
    dtype = np.result_type(Ypos.dtype, Yrot.dtype)
    grot, gpos = quat.fk(torch.from_numpy(Yrot.astype(dtype)),
                         torch.from_numpy(Ypos.astype(dtype)), parents)
    out_pos = Ypos[:, 1:].copy()
    out_rot = Yrot[:, 1:].copy()
    out_pos[:, 0] = gpos[:, 1].numpy()
    out_rot[:, 0] = grot[:, 1].numpy()
    return out_pos, out_rot


def save_characterized_bvh(path: str, Ypos: np.ndarray, Yrot: np.ndarray,
                           parents_with_root, names: Sequence[str],
                           order: str = "zyx",
                           frametime: float = 1.0 / 60.0) -> None:
    """Write a characterized stream to BVH (the original 24-joint rig).

    The angles come from ``quat.to_euler`` in its default 'xyz' order while
    the file is labelled ``order``, as the JAX package writes them."""
    pos, rot = reroot_to_hips(Ypos, Yrot, parents_with_root)
    parents_original = np.asarray(parents_with_root)[1:] - 1
    parents_original[0] = -1
    bvh.save(path, {
        "rotations": np.degrees(quat.to_euler(torch.from_numpy(rot)).numpy()),
        "positions": pos,
        "offsets": pos[0],
        "parents": parents_original,
        "names": list(names),
        "order": order,
    }, frametime=frametime)
