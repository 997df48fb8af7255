"""Spring helpers + the foot-contact state machine, branchless.

Counterpart of mocha_sigasia2023_tpu/kinematics/inertial.py:20-177.  The
state is a NamedTuple of tensors batched over any leading axes (streams,
contact bones); whole-pose inertialization is not on the serving path and
is not ported here.
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
