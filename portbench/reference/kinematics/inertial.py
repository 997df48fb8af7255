"""Inertialization springs, the foot-contact state machine and whole-pose
inertialization, branchless.

Counterpart of mocha_sigasia2023_tpu/kinematics/inertial.py.  The states
(``ContactState``, ``PoseOffsets``) are NamedTuples of tensors batched over
any leading axes (streams, contact bones).  Serving runs the contact
machine; the whole-pose inertializer (``PoseOffsets``, ``pose_transition``,
``pose_update``) has no caller in either package and is held to the JAX
functions by the tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import quat


def fast_negexpf(x):
    """Cheap approximation of exp(-x)."""
    return 1.0 / (1.0 + x + 0.48 * x * x + 0.235 * x * x * x)


def halflife_to_damping(halflife, eps=1e-5):
    return (4.0 * math.log(2.0)) / (halflife + eps)


def decay_spring_damper_pos(x, v, halflife, dt):
    """Critically damped spring decay toward zero for vectors."""
    y = halflife_to_damping(halflife) / 2.0
    j1 = v + x * y
    eydt = fast_negexpf(y * dt)
    return eydt * (x + j1 * dt), eydt * (v - j1 * y * dt)


def decay_spring_damper_rot(x, v, halflife, dt):
    """Spring decay toward identity for quaternion offsets."""
    y = halflife_to_damping(halflife) / 2.0
    j0 = quat.to_scaled_angle_axis(x)
    j1 = v + j0 * y
    eydt = fast_negexpf(y * dt)
    return (quat.from_scaled_angle_axis(eydt * (j0 + j1 * dt)),
            eydt * (v - j1 * y * dt))


def transition_pos(off_x, off_v, src_x, src_v, dst_x, dst_v):
    return (src_x + off_x) - dst_x, (src_v + off_v) - dst_v


def update_pos(off_x, off_v, in_x, in_v, halflife, dt):
    """-> out_x, out_v, off_x, off_v"""
    off_x, off_v = decay_spring_damper_pos(off_x, off_v, halflife, dt)
    return in_x + off_x, in_v + off_v, off_x, off_v


def transition_rot(off_x, off_v, src_x, src_v, dst_x, dst_v):
    off_x = quat.abs_(quat.mul(quat.mul(off_x, src_x), quat.inv(dst_x)))
    return off_x, (off_v + src_v) - dst_v


def update_rot(off_x, off_v, in_x, in_v, halflife, dt):
    """-> out_x, out_v, off_x, off_v"""
    off_x, off_v = decay_spring_damper_rot(off_x, off_v, halflife, dt)
    return quat.mul(off_x, in_x), off_v + in_v, off_x, off_v


class ContactState(NamedTuple):
    """Per-contact-bone carried state, batched over any leading axes."""

    state: torch.Tensor            # (...,)   bool — contact active last frame
    lock: torch.Tensor             # (...,)   bool — foot currently locked
    position: torch.Tensor         # (..., 3) inertialized contact position
    velocity: torch.Tensor         # (..., 3)
    point: torch.Tensor            # (..., 3) locked ground point
    target: torch.Tensor           # (..., 3) previous raw input position
    offset_position: torch.Tensor  # (..., 3) inertializer offset
    offset_velocity: torch.Tensor  # (..., 3)

    @staticmethod
    def init(toe_positions, toe_velocities=None):
        """Unlocked, pinned at the toe's current global position."""
        p = toe_positions
        z = torch.zeros_like(p)
        flags = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
        return ContactState(
            state=flags, lock=flags.clone(), position=p,
            velocity=z if toe_velocities is None else toe_velocities,
            point=p, target=p, offset_position=z, offset_velocity=z)


def contact_update(cs: ContactState, input_position, input_state,
                   unlock_radius, foot_height, halflife, dt,
                   eps=1e-8) -> ContactState:
    """Branchless lock/unlock state machine; inputs broadcast over the
    state's leading axes."""
    input_state = torch.as_tensor(input_state).to(torch.bool)

    input_velocity = (input_position - cs.target) / (dt + eps)
    zeros_v = torch.zeros_like(input_velocity)

    lock_b = cs.lock[..., None]
    in_x = torch.where(lock_b, cs.point, input_position)
    in_v = torch.where(lock_b, zeros_v, input_velocity)
    position, velocity, off_p, off_v = update_pos(
        cs.offset_position, cs.offset_velocity, in_x, in_v, halflife, dt)

    unlock = cs.lock & (quat.length(cs.point - input_position)
                        > unlock_radius)

    just_locked = (~cs.state) & input_state
    lock_point = torch.cat(
        [position[..., 0:1], torch.full_like(position[..., 1:2], foot_height),
         position[..., 2:3]], dim=-1)
    t1_off_p, t1_off_v = transition_pos(
        off_p, off_v, input_position, input_velocity, lock_point, zeros_v)

    just_unlocked = (~just_locked) & (
        (cs.lock & cs.state & (~input_state)) | unlock)
    t2_off_p, t2_off_v = transition_pos(
        off_p, off_v, cs.point, zeros_v, input_position, input_velocity)

    jl = just_locked[..., None]
    ju = just_unlocked[..., None]
    new_off_p = torch.where(jl, t1_off_p, torch.where(ju, t2_off_p, off_p))
    new_off_v = torch.where(jl, t1_off_v, torch.where(ju, t2_off_v, off_v))
    new_point = torch.where(jl, lock_point, cs.point)
    new_lock = torch.where(just_locked, True,
                           torch.where(just_unlocked, False, cs.lock))

    return ContactState(
        state=input_state, lock=new_lock, position=position,
        velocity=velocity, point=new_point, target=input_position,
        offset_position=new_off_p, offset_velocity=new_off_v)


class PoseOffsets(NamedTuple):
    """Whole-pose inertializer offsets."""

    pos: torch.Tensor   # (..., J, 3)
    vel: torch.Tensor   # (..., J, 3)
    rot: torch.Tensor   # (..., J, 4)
    ang: torch.Tensor   # (..., J, 3)

    @staticmethod
    def zeros(shape_j, dtype=torch.float32, device=None):
        j = shape_j if isinstance(shape_j, tuple) else (shape_j,)

        def z(*tail):
            return torch.zeros(j + tail, dtype=dtype, device=device)

        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return PoseOffsets(pos=z(3), vel=z(3), rot=ident.expand(j + (4,)),
                           ang=z(3))


def pose_transition(off: PoseOffsets, root_position, root_velocity,
                    root_rotation, root_angular_velocity,
                    src_pos, src_vel, src_rot, src_ang,
                    dst_pos, dst_vel, dst_rot, dst_ang):
    """Whole-pose transition.  Bone 0 is the root and takes world-space
    destination velocities.  Returns (offsets, (t_src_pos, t_src_rot,
    t_dst_pos, t_dst_rot))."""
    t_dst_pos, t_dst_rot = root_position, root_rotation
    t_src_pos = dst_pos[..., 0, :]
    t_src_rot = dst_rot[..., 0, :]

    ws_dst_vel = quat.mul_vec(t_dst_rot,
                              quat.mul_vec(t_src_rot, dst_vel[..., 0, :]))
    ws_dst_ang = quat.mul_vec(t_dst_rot,
                              quat.mul_vec(t_src_rot, dst_ang[..., 0, :]))

    r_off_p, r_off_v = transition_pos(
        off.pos[..., 0, :], off.vel[..., 0, :],
        root_position, root_velocity, root_position, ws_dst_vel)
    r_off_r, r_off_a = transition_rot(
        off.rot[..., 0, :], off.ang[..., 0, :],
        root_rotation, root_angular_velocity, root_rotation, ws_dst_ang)
    b_off_p, b_off_v = transition_pos(
        off.pos[..., 1:, :], off.vel[..., 1:, :],
        src_pos[..., 1:, :], src_vel[..., 1:, :],
        dst_pos[..., 1:, :], dst_vel[..., 1:, :])
    b_off_r, b_off_a = transition_rot(
        off.rot[..., 1:, :], off.ang[..., 1:, :],
        src_rot[..., 1:, :], src_ang[..., 1:, :],
        dst_rot[..., 1:, :], dst_ang[..., 1:, :])

    def join(root, rest):
        return torch.cat([root[..., None, :], rest], dim=-2)

    new = PoseOffsets(pos=join(r_off_p, b_off_p), vel=join(r_off_v, b_off_v),
                      rot=join(r_off_r, b_off_r), ang=join(r_off_a, b_off_a))
    return new, (t_src_pos, t_src_rot, t_dst_pos, t_dst_rot)


def pose_update(off: PoseOffsets, in_pos, in_vel, in_rot, in_ang,
                transition, halflife, dt):
    """Whole-pose inertializer tick: the root's input moved into the
    transition's world frame, then every bone's offsets decayed and added.
    Returns (pos, vel, rot, ang, new_offsets)."""
    t_src_pos, t_src_rot, t_dst_pos, t_dst_rot = transition

    ws_pos = quat.mul_vec(t_dst_rot, quat.inv_mul_vec(
        t_src_rot, in_pos[..., 0, :] - t_src_pos)) + t_dst_pos
    ws_vel = quat.mul_vec(t_dst_rot,
                          quat.inv_mul_vec(t_src_rot, in_vel[..., 0, :]))
    ws_rot = quat.normalize(quat.mul(t_dst_rot,
                                     quat.inv_mul(t_src_rot,
                                                  in_rot[..., 0, :])))
    ws_ang = quat.mul_vec(t_dst_rot,
                          quat.inv_mul_vec(t_src_rot, in_ang[..., 0, :]))

    def with_root(root, x):
        return torch.cat([root[..., None, :], x[..., 1:, :]], dim=-2)

    pos, vel, off_p, off_v = update_pos(
        off.pos, off.vel, with_root(ws_pos, in_pos),
        with_root(ws_vel, in_vel), halflife, dt)
    rot, ang, off_r, off_a = update_rot(
        off.rot, off.ang, with_root(ws_rot, in_rot),
        with_root(ws_ang, in_ang), halflife, dt)
    return pos, vel, rot, ang, PoseOffsets(off_p, off_v, off_r, off_a)
