"""BVH clip arrays -> per-frame motion features (PyTorch).

Counterpart of mocha_sigasia2023_tpu/data/preprocess.py:41-280:

  1. Euler degrees -> unrolled quaternions; cm -> m.
  1b. Optional mirroring (FK -> reflect x -> conjugate rotations -> IK), as
     the dataset build uses it.
  2. Root-bone synthesis: ground-projected Spine2 position (Savitzky-Golay
     window 15, order 3) + heading from the shoulder/hip "across" vector
     (window 31), prepended as bone 0 (24 joints -> 25 bones).
  3. Central-difference linear/angular velocities, endpoints extrapolated.
  4. Toe-speed foot contacts, majority-vote median filter (size 6).

Clips may carry a leading batch axis: inputs are (T, J, 3) or (S, T, J, 3)
and every stage runs on the time axis of the batched form, in place of the
JAX package's vmap.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kinematics import quat


@functools.lru_cache(maxsize=None)
def _savgol_matrices(window: int,
                     polyorder: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(center taps, left-edge rows, right-edge rows) of the least-squares
    polynomial fit, in float64 (scipy ``mode='interp'`` semantics)."""
    half = window // 2
    j = np.arange(window, dtype=np.float64)
    P = np.linalg.pinv(np.vander(j, polyorder + 1, increasing=True))

    def eval_rows(positions):
        E = np.vander(np.asarray(positions, np.float64), polyorder + 1,
                      increasing=True)
        return E @ P

    center = eval_rows([half])[0]
    left = eval_rows(np.arange(half))
    right = eval_rows(np.arange(half + 1, window))
    return center, left, right


def savgol_filter(x: torch.Tensor, window: int, polyorder: int) -> torch.Tensor:
    """Savitzky-Golay along axis 1 of (S, T, ...), T >= window: interior as
    an FIR convolution, edges as two small matmuls."""
    center, left, right = _savgol_matrices(window, polyorder)
    S, T = x.shape[:2]
    flat = x.reshape(S, T, -1)
    C = flat.shape[2]
    taps = torch.as_tensor(center[::-1].copy(), dtype=x.dtype,
                           device=x.device)[None, None, :]
    lhs = flat.permute(0, 2, 1).reshape(S * C, 1, T)
    interior = F.conv1d(lhs, taps).reshape(S, C, T - window + 1)
    interior = interior.permute(0, 2, 1)
    lm = torch.as_tensor(left, dtype=x.dtype, device=x.device)
    rm = torch.as_tensor(right, dtype=x.dtype, device=x.device)
    head = torch.einsum("hw,swc->shc", lm, flat[:, :window])
    tail = torch.einsum("hw,swc->shc", rm, flat[:, -window:])
    return torch.cat([head, interior, tail], dim=1).reshape(x.shape)


def median_vote(contacts: torch.Tensor, size: int = 6) -> torch.Tensor:
    """Boolean median filter along axis 1 of (S, T, ...), matching
    scipy.ndimage.median_filter(size, mode='nearest') on 0/1 input."""
    k = size
    lead, trail = k // 2, k - 1 - k // 2
    x = contacts.to(torch.int32)
    xp = torch.cat([x[:, :1].expand(-1, lead, *x.shape[2:]), x,
                    x[:, -1:].expand(-1, trail, *x.shape[2:])], dim=1)
    c = torch.cumsum(xp, dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    counts = c[:, k:] - c[:, :-k]
    return counts >= (k - k // 2)


def central_velocity(positions, fps: float = 60.0):
    """Central-difference velocity along axis 1 with endpoint
    extrapolation."""
    inner = 0.5 * (positions[:, 2:] - positions[:, 1:-1]) * fps + \
        0.5 * (positions[:, 1:-1] - positions[:, :-2]) * fps
    first = inner[:, 0] - (inner[:, 2] - inner[:, 1])
    last = inner[:, -1] + (inner[:, -1] - inner[:, -2])
    return torch.cat([first[:, None], inner, last[:, None]], dim=1)


def central_angular_velocity(rotations, fps: float = 60.0):
    """Central-difference angular velocity along axis 1."""
    fwd = quat.to_scaled_angle_axis(
        quat.abs_(quat.mul_inv(rotations[:, 2:], rotations[:, 1:-1])))
    bwd = quat.to_scaled_angle_axis(
        quat.abs_(quat.mul_inv(rotations[:, 1:-1], rotations[:, :-2])))
    inner = 0.5 * fwd * fps + 0.5 * bwd * fps
    first = inner[:, 0] - (inner[:, 2] - inner[:, 1])
    last = inner[:, -1] + (inner[:, -1] - inner[:, -2])
    return torch.cat([first[:, None], inner, last[:, None]], dim=1)


def mirror_map(names: Sequence[str]) -> np.ndarray:
    """Left<->Right joint permutation from the joint names."""
    idx = []
    for n in names:
        if n.startswith("Right"):
            idx.append(names.index("Left" + n[5:]))
        elif n.startswith("Left"):
            idx.append(names.index("Right" + n[4:]))
        else:
            idx.append(names.index(n))
    return np.asarray(idx, dtype=np.int32)


def animation_mirror(lrot, lpos, names, parents):
    """Mirror local rotations and positions (..., J, .) across the x plane:
    FK, reflect the world positions, conjugate the world rotation matrices
    with a sign mask and swap Left/Right joints, then IK back to locals."""
    jm = quat.index(mirror_map(list(names)).tolist(), lrot.device)
    mirror_pos = quat.const([-1.0, 1.0, 1.0], lpos)
    mirror_rot = torch.tensor([[-1.0, -1.0, 1.0], [1.0, 1.0, -1.0],
                               [1.0, 1.0, -1.0]], dtype=lrot.dtype,
                              device=lrot.device)
    grot, gpos = quat.fk(lrot, lpos, parents)
    gpos_m = mirror_pos * gpos[..., jm, :]
    grot_m = quat.from_xform(mirror_rot * quat.to_xform(grot[..., jm, :]))
    return quat.ik(grot_m, gpos_m, parents)


ROOT_POSITION_JOINT = "Spine2"
ACROSS_JOINTS = ("LeftShoulder", "RightShoulder", "LeftUpLeg", "RightUpLeg")
CONTACT_JOINTS = ("LeftToeBase", "RightToeBase")
ARRAY_KEYS = ("positions", "velocities", "rotations", "angular_velocities",
              "contacts")


def featurize_clip(rotations_deg: torch.Tensor, positions_cm: torch.Tensor,
                   order: str, names: Sequence[str], parents: Sequence[int],
                   *, mirror: bool = False,
                   contact_velocity_threshold: float = 0.5,
                   fps: float = 60.0) -> Dict:
    """BVH arrays -> per-frame features over the (J+1)-bone rig with a
    synthesized root: dict(positions, velocities, rotations,
    angular_velocities, contacts) plus ``bone_parents``/``bone_names``.
    Inputs (T, J, 3) or (S, T, J, 3); outputs keep that leading shape.
    ``mirror`` mirrors the raw local pose before the root is synthesized."""
    names = list(names)
    parents = np.asarray(parents)
    single = rotations_deg.dim() == 3
    if single:
        rotations_deg, positions_cm = rotations_deg[None], positions_cm[None]

    rotations = quat.unroll(
        quat.from_euler(torch.deg2rad(rotations_deg), order=order), dim=1)
    positions = positions_cm * 0.01

    if mirror:
        rotations, positions = animation_mirror(rotations, positions, names,
                                                parents)
        rotations = quat.unroll(rotations, dim=1)

    _, gpos = quat.fk(rotations, positions, parents)

    xz = quat.const([1.0, 0.0, 1.0], positions)
    spine = names.index(ROOT_POSITION_JOINT)
    root_position = savgol_filter(xz * gpos[:, :, spine: spine + 1], 15, 3)

    sdr_l, sdr_r, hip_l, hip_r = (names.index(n) for n in ACROSS_JOINTS)
    across = ((gpos[:, :, sdr_l: sdr_l + 1] - gpos[:, :, sdr_r: sdr_r + 1])
              + (gpos[:, :, hip_l: hip_l + 1] - gpos[:, :, hip_r: hip_r + 1]))
    up = quat.const([0.0, 1.0, 0.0], positions).expand_as(across)
    root_dir = xz * torch.linalg.cross(across, up, dim=-1)
    root_dir = root_dir / torch.sqrt(torch.sum(root_dir ** 2, dim=-1))[..., None]
    root_dir = savgol_filter(root_dir, 31, 3)
    root_dir = root_dir / torch.sqrt(torch.sum(root_dir ** 2, dim=-1))[..., None]
    fwd = quat.const([0.0, 0.0, 1.0], positions).expand_as(root_dir)
    root_rotation = quat.normalize(quat.between(fwd, root_dir))

    inv_root = quat.inv(root_rotation)
    hips_pos = quat.mul_vec(inv_root, positions[:, :, 0:1] - root_position)
    hips_rot = quat.mul(inv_root, rotations[:, :, 0:1])
    positions = torch.cat([root_position, hips_pos, positions[:, :, 1:]], dim=2)
    rotations = torch.cat([root_rotation, hips_rot, rotations[:, :, 1:]], dim=2)

    bone_parents = np.concatenate([[-1], parents + 1])
    bone_names = ["Root"] + names

    velocities = central_velocity(positions, fps)
    angular_velocities = central_angular_velocity(rotations, fps)
    _, _, gvel, _ = quat.fk_vel(rotations, positions, velocities,
                                angular_velocities, bone_parents)

    toes = quat.index([bone_names.index(n) for n in CONTACT_JOINTS],
                      positions.device)
    contact_speed = torch.sqrt(torch.sum(gvel[:, :, toes] ** 2, dim=-1))
    contacts = median_vote(contact_speed < contact_velocity_threshold, size=6)

    out = {"positions": positions, "velocities": velocities,
           "rotations": rotations, "angular_velocities": angular_velocities,
           "contacts": contacts}
    if single:
        out = {k: v[0] for k, v in out.items()}
    out["bone_parents"] = bone_parents
    out["bone_names"] = bone_names
    return out
