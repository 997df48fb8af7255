"""Quaternion algebra + forward/inverse kinematics in PyTorch.

Counterpart of mocha_sigasia2023_tpu/kinematics/quat.py (the ops the
featurizer and the stream step call).  Quaternions are (w, x, y, z) in the
last axis; joints live on axis -2; every function broadcasts over leading
axes (time, windows, streams).  ``parents`` is a static int sequence with
-1 at the root.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.numerics import safe_sqrt, safe_unit_denom


@functools.lru_cache(maxsize=None)
def _index(ids: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def index(ids, device) -> torch.Tensor:
    """Cached long tensor of static indices on ``device``."""
    return _index(tuple(int(i) for i in ids), torch.device(device))


def _cross(a, b):
    return torch.cat(
        [
            a[..., 1:2] * b[..., 2:3] - a[..., 2:3] * b[..., 1:2],
            a[..., 2:3] * b[..., 0:1] - a[..., 0:1] * b[..., 2:3],
            a[..., 0:1] * b[..., 1:2] - a[..., 1:2] * b[..., 0:1],
        ],
        dim=-1,
    )


@functools.lru_cache(maxsize=None)
def _const_cached(values: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, like: torch.Tensor) -> torch.Tensor:
    """Cached constant vector with ``like``'s dtype and device (a fresh
    host-to-device copy per call would stall the stream step's queue)."""
    return _const_cached(tuple(float(v) for v in values), like.dtype,
                         like.device)


def eye(shape=(), dtype=torch.float32, device=None):
    """Identity quaternion broadcast to ``shape + (4,)``."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=device).expand(tuple(shape) + (4,))


def length(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def normalize(x, eps=1e-8):
    return x / (safe_sqrt(torch.sum(x * x, dim=-1), 1e-30)[..., None] + eps)


def abs_(x):
    """Hemisphere fix: negate quaternions with non-positive w."""
    return torch.where(x[..., 0:1] > 0.0, x, -x)


def from_angle_axis(angle, axis):
    c = torch.cos(angle / 2.0)[..., None]
    s = torch.sin(angle / 2.0)[..., None]
    return torch.cat([c, s * axis], dim=-1)


def _xform_terms(q):
    qw, qx, qy, qz = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    x2, y2, z2 = qx + qx, qy + qy, qz + qz
    xx, yy, wx = qx * x2, qy * y2, qw * x2
    xy, yz, wy = qx * y2, qy * z2, qw * y2
    xz, zz, wz = qx * z2, qz * z2, qw * z2
    return xx, yy, zz, xy, yz, xz, wx, wy, wz


def to_xform(q):
    """Quaternion -> 3x3 rotation matrix (rows on axis -2)."""
    xx, yy, zz, xy, yz, xz, wx, wy, wz = _xform_terms(q)
    r0 = torch.cat([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1)
    r1 = torch.cat([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1)
    r2 = torch.cat([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def to_xform_xy(q):
    """Quaternion -> first two rotation-matrix columns, shape (..., 3, 2)."""
    xx, yy, zz, xy, yz, xz, wx, wy, wz = _xform_terms(q)
    r0 = torch.cat([1.0 - (yy + zz), xy - wz], dim=-1)
    r1 = torch.cat([xy + wz, 1.0 - (xx + zz)], dim=-1)
    r2 = torch.cat([xz - wy, yz + wx], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def from_euler(e, order="zyx"):
    """Intrinsic Euler angles (radians) -> quaternion."""
    axes = {"x": [1.0, 0.0, 0.0], "y": [0.0, 1.0, 0.0], "z": [0.0, 0.0, 1.0]}
    q0 = from_angle_axis(e[..., 0], const(axes[order[0]], e))
    q1 = from_angle_axis(e[..., 1], const(axes[order[1]], e))
    q2 = from_angle_axis(e[..., 2], const(axes[order[2]], e))
    return mul(q0, mul(q1, q2))


def from_xform(m):
    """3x3 rotation matrix -> quaternion, branch per largest diagonal."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    cand_x = torch.stack(
        [m[..., 2, 1] - m[..., 1, 2], 1.0 + m00 - m11 - m22,
         m[..., 1, 0] + m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    cand_y = torch.stack(
        [m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] + m[..., 0, 1],
         1.0 - m00 + m11 - m22, m[..., 2, 1] + m[..., 1, 2]], dim=-1)
    cand_z = torch.stack(
        [m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
         m[..., 2, 1] + m[..., 1, 2], 1.0 - m00 - m11 + m22], dim=-1)
    cand_w = torch.stack(
        [1.0 + m00 + m11 + m22, m[..., 2, 1] - m[..., 1, 2],
         m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    q = torch.where(
        (m22 < 0.0)[..., None],
        torch.where((m00 > m11)[..., None], cand_x, cand_y),
        torch.where((m00 < -m11)[..., None], cand_z, cand_w),
    )
    return normalize(q)


def from_xform_xy(xy):
    """6D two-column representation (..., 3, 2) -> quaternion."""
    c0 = xy[..., 0]
    c2 = _cross(c0, xy[..., 1])
    c2 = c2 / safe_unit_denom(c2)
    c1 = _cross(c2, c0)
    c1 = c1 / safe_unit_denom(c1)
    return from_xform(torch.stack([c0, c1, c2], dim=-1))


def inv(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def mul(x, y):
    """Hamilton product x * y."""
    x0, x1, x2, x3 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    y0, y1, y2, y3 = y[..., 0:1], y[..., 1:2], y[..., 2:3], y[..., 3:4]
    return torch.cat(
        [
            y0 * x0 - y1 * x1 - y2 * x2 - y3 * x3,
            y0 * x1 + y1 * x0 - y2 * x3 + y3 * x2,
            y0 * x2 + y1 * x3 + y2 * x0 - y3 * x1,
            y0 * x3 - y1 * x2 + y2 * x1 + y3 * x0,
        ],
        dim=-1,
    )


def inv_mul(x, y):
    return mul(inv(x), y)


def mul_inv(x, y):
    return mul(x, inv(y))


def mul_vec(q, v):
    """Rotate vector v by quaternion q."""
    t = 2.0 * _cross(q[..., 1:], v)
    return v + q[..., 0][..., None] * t + _cross(q[..., 1:], t)


def inv_mul_vec(q, v):
    return mul_vec(inv(q), v)


def unroll(x, dim=0):
    """Temporal hemisphere unrolling as a running product of flip signs."""
    x = torch.movedim(x, dim, 0)
    d = torch.sum(x[1:] * x[:-1], dim=-1)
    step = torch.where(d < 0.0, -1.0, 1.0).to(x.dtype)
    sign = torch.cat([torch.ones_like(step[:1]),
                      torch.cumprod(step, dim=0)], dim=0)
    return torch.movedim(sign[..., None] * x, 0, dim)


def between(u, v):
    """Quaternion rotating direction u onto v."""
    w = (torch.sqrt(torch.sum(u * u, dim=-1) * torch.sum(v * v, dim=-1))
         + torch.sum(u * v, dim=-1))[..., None]
    return torch.cat([w, _cross(u, v)], dim=-1)


def log(q, eps=1e-5):
    v_len = safe_sqrt(torch.sum(q[..., 1:] ** 2, dim=-1), 1e-30)[..., None]
    small = v_len < eps
    safe = torch.where(small, torch.ones_like(v_len), v_len)
    halfangle = torch.where(small, torch.ones_like(v_len),
                            torch.atan2(v_len, q[..., 0:1]) / safe)
    return halfangle * q[..., 1:]


def exp(v, eps=1e-5):
    halfangle = safe_sqrt(torch.sum(v * v, dim=-1), 1e-30)[..., None]
    small = halfangle < eps
    c = torch.where(small, torch.ones_like(halfangle), torch.cos(halfangle))
    s = torch.where(small, torch.ones_like(halfangle),
                    torch.sinc(halfangle / np.pi))
    return torch.cat([c, s * v], dim=-1)


def to_scaled_angle_axis(q, eps=1e-5):
    return 2.0 * log(q, eps)


def from_scaled_angle_axis(v, eps=1e-5):
    return exp(v / 2.0, eps)


def to_euler(q, order="xyz"):
    """Quaternion -> Euler angles (radians); 'xyz' and 'yzx'."""
    q0, q1, q2, q3 = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    if order == "xyz":
        return torch.cat([
            torch.atan2(2.0 * (q0 * q1 + q2 * q3),
                        1.0 - 2.0 * (q1 * q1 + q2 * q2)),
            torch.asin(torch.clamp(2.0 * (q0 * q2 - q3 * q1), -1.0, 1.0)),
            torch.atan2(2.0 * (q0 * q3 + q1 * q2),
                        1.0 - 2.0 * (q2 * q2 + q3 * q3)),
        ], dim=-1)
    if order == "yzx":
        return torch.cat([
            torch.atan2(2.0 * (q1 * q0 - q2 * q3),
                        -q1 * q1 + q2 * q2 - q3 * q3 + q0 * q0),
            torch.atan2(2.0 * (q2 * q0 - q1 * q3),
                        q1 * q1 - q2 * q2 - q3 * q3 + q0 * q0),
            torch.asin(torch.clamp(2.0 * (q1 * q2 + q3 * q0), -1.0, 1.0)),
        ], dim=-1)
    raise NotImplementedError(f"Cannot convert to ordering {order!r}")


# ---------------------------------------------------------------------------
# Forward / inverse kinematics
# ---------------------------------------------------------------------------


def _as_parents_key(parents) -> tuple:
    return tuple(int(p) for p in np.asarray(parents).tolist())


@functools.lru_cache(maxsize=None)
def topo_levels(parents: tuple) -> tuple:
    """Joint ids grouped by tree depth, with their parents per level."""
    depth = []
    for p in parents:
        depth.append(0 if p < 0 else depth[p] + 1)
    levels, level_parents = [], []
    for d in range(max(depth) + 1):
        ids = tuple(j for j in range(len(parents)) if depth[j] == d)
        levels.append(ids)
        level_parents.append(tuple(parents[j] for j in ids))
    return tuple(levels), tuple(level_parents)


@functools.lru_cache(maxsize=None)
def chain_to_root(parents: tuple, bone: int) -> tuple:
    """Static root->bone index chain."""
    chain = []
    b = int(bone)
    while b != -1:
        chain.append(b)
        b = int(parents[b])
    return tuple(reversed(chain))


@functools.lru_cache(maxsize=None)
def ancestor_chains(parents: tuple) -> np.ndarray:
    """Static (J, D) ancestor table: row j lists root..j, front-padded with
    the index J (an identity bone appended by :func:`_with_identity`)."""
    J = len(parents)
    chains = []
    for j in range(J):
        c, b = [], j
        while b != -1:
            c.append(b)
            b = int(parents[b])
        chains.append(c[::-1])
    D = max(len(c) for c in chains)
    anc = np.full((J, D), J, dtype=np.int64)
    for j, c in enumerate(chains):
        anc[j, D - len(c):] = c
    anc.setflags(write=False)
    return anc


def _with_identity(*arrays):
    """Append an identity bone at index J: the unit quaternion to the
    rotations (the first array), zeros to the vectors."""
    lrot = arrays[0]
    ident = const((1.0, 0.0, 0.0, 0.0), lrot).expand(lrot.shape[:-2] + (1, 4))
    out = [torch.cat([lrot, ident], dim=-2)]
    for a in arrays[1:]:
        out.append(torch.cat([a, a.new_zeros(a.shape[:-2] + (1, 3))], dim=-2))
    return out


def fk_vel_chain_all(lrot, lpos, lvel, lang, parents):
    """:func:`fk_vel` over ancestor chains: every joint accumulates the
    products along its static root-to-joint chain, by gathers alone (no
    in-place writes), the form the training losses differentiate."""
    anc = ancestor_chains(_as_parents_key(parents))
    lrotp, lposp, lvelp, langp = _with_identity(lrot, lpos, lvel, lang)
    col = index(anc[:, 0], lrot.device)
    gr, gp = lrotp[..., col, :], lposp[..., col, :]
    gv, ga = lvelp[..., col, :], langp[..., col, :]
    for d in range(1, anc.shape[1]):
        col = index(anc[:, d], lrot.device)
        rp = mul_vec(gr, lposp[..., col, :])
        gv = gv + mul_vec(gr, lvelp[..., col, :]) + _cross(ga, rp)
        ga = ga + mul_vec(gr, langp[..., col, :])
        gp = gp + rp
        gr = mul(gr, lrotp[..., col, :])
    return gr, gp, gv, ga


def fk_chain_all(lrot, lpos, parents):
    """:func:`fk` over ancestor chains: every joint accumulates the product
    along its static root-to-joint chain, by gathers alone."""
    anc = ancestor_chains(_as_parents_key(parents))
    lrotp, lposp = _with_identity(lrot, lpos)
    col = index(anc[:, 0], lrot.device)
    gr, gp = lrotp[..., col, :], lposp[..., col, :]
    for d in range(1, anc.shape[1]):
        col = index(anc[:, d], lrot.device)
        gp = gp + mul_vec(gr, lposp[..., col, :])
        gr = mul(gr, lrotp[..., col, :])
    return gr, gp


def fk_chain(lrot, lpos, parents, bone):
    """Global rotation and position of every joint on the root-to-``bone``
    chain: {joint: (grot, gpos)}."""
    chain = chain_to_root(_as_parents_key(parents), int(bone))
    gr, gp = lrot[..., chain[0], :], lpos[..., chain[0], :]
    out = {chain[0]: (gr, gp)}
    for j in chain[1:]:
        gp = mul_vec(gr, lpos[..., j, :]) + gp
        gr = mul(gr, lrot[..., j, :])
        out[j] = (gr, gp)
    return out


def fk(lrot, lpos, parents):
    """Local -> global rotations/positions, one batched update per tree
    level.  lrot (..., J, 4), lpos (..., J, 3)."""
    levels, lparents = topo_levels(_as_parents_key(parents))
    grot, gpos = lrot.clone(), lpos.clone()
    for lvl, par in zip(levels[1:], lparents[1:]):
        li, pi = index(lvl, lrot.device), index(par, lrot.device)
        pr = grot[..., pi, :]
        grot[..., li, :] = mul(pr, lrot[..., li, :])
        gpos[..., li, :] = mul_vec(pr, lpos[..., li, :]) + gpos[..., pi, :]
    return grot, gpos


def ik(grot, gpos, parents):
    """Global -> local."""
    par = index(np.asarray(parents)[1:], grot.device)
    pr = grot[..., par, :]
    return (
        torch.cat([grot[..., :1, :], mul(inv(pr), grot[..., 1:, :])], dim=-2),
        torch.cat([gpos[..., :1, :],
                   mul_vec(inv(pr), gpos[..., 1:, :] - gpos[..., par, :])],
                  dim=-2),
    )


def fk_vel(lrot, lpos, lvel, lang, parents):
    """FK propagating linear and angular velocities (level-scheduled)."""
    levels, lparents = topo_levels(_as_parents_key(parents))
    grot, gpos = lrot.clone(), lpos.clone()
    gvel, gang = lvel.clone(), lang.clone()
    for lvl, par in zip(levels[1:], lparents[1:]):
        li, pi = index(lvl, lrot.device), index(par, lrot.device)
        pr = grot[..., pi, :]
        pp = gpos[..., pi, :]
        pv = gvel[..., pi, :]
        pa = gang[..., pi, :]
        rp = mul_vec(pr, lpos[..., li, :])
        grot[..., li, :] = mul(pr, lrot[..., li, :])
        gpos[..., li, :] = rp + pp
        gvel[..., li, :] = mul_vec(pr, lvel[..., li, :]) + _cross(pa, rp) + pv
        gang[..., li, :] = mul_vec(pr, lang[..., li, :]) + pa
    return grot, gpos, gvel, gang


def fk_vel_bone(lrot, lpos, lvel, lang, parents, bone):
    """Global position, velocity, rotation and angular velocity of one bone,
    along its static root->bone chain."""
    chain = chain_to_root(_as_parents_key(parents), int(bone))
    j0 = chain[0]
    gp, gv = lpos[..., j0, :], lvel[..., j0, :]
    gr, ga = lrot[..., j0, :], lang[..., j0, :]
    for j in chain[1:]:
        rp = mul_vec(gr, lpos[..., j, :])
        gp_new = rp + gp
        gv = gv + mul_vec(gr, lvel[..., j, :]) + _cross(ga, rp)
        ga_new = ga + mul_vec(gr, lang[..., j, :])
        gr = mul(gr, lrot[..., j, :])
        gp, ga = gp_new, ga_new
    return gp, gv, gr, ga


def ik_look_at(bone_rotation, global_parent_rotation, global_rotation,
               global_position, child_position, target_position, eps=1e-5):
    """Aim a joint at a target, branchless: the bone's local rotation that
    turns its child's direction onto the target's, or ``bone_rotation``
    where the two already agree within ``eps``."""
    curr_dir = normalize(child_position - global_position)
    targ_dir = normalize(target_position - global_position)
    rotated = inv_mul(global_parent_rotation,
                      mul(between(curr_dir, targ_dir), global_rotation))
    needs = (torch.abs(1.0 - torch.sum(curr_dir * targ_dir, dim=-1))
             > eps)[..., None]
    return torch.where(needs, rotated, bone_rotation)


def ik_two_bone(bone_root_lr, bone_mid_lr, bone_root, bone_mid, bone_end,
                target, fwd, bone_root_gr, bone_mid_gr, bone_par_gr,
                max_length_buffer):
    """Analytic two-joint IK with pole vector, batched over leading axes.
    Returns new local rotations for the root (hip) and mid (knee) joints."""

    def _dot(a, b):
        return torch.sum(a * b, dim=-1)

    max_extension = (length(bone_root - bone_mid)
                     + length(bone_mid - bone_end) - max_length_buffer)
    too_far = (length(target - bone_root) > max_extension)[..., None]
    target_clamp = torch.where(
        too_far,
        bone_root + max_extension[..., None] * normalize(target - bone_root),
        target)

    axis_dwn = normalize(bone_end - bone_root)
    axis_rot = normalize(_cross(axis_dwn, fwd))

    a, b, c, t = bone_root, bone_mid, bone_end, target_clamp
    lab = length(b - a)
    lcb = length(b - c)
    lat = length(t - a)

    ac_ab_0 = torch.arccos(torch.clamp(
        _dot(normalize(c - a), normalize(b - a)), -1.0, 1.0))
    ba_bc_0 = torch.arccos(torch.clamp(
        _dot(normalize(a - b), normalize(c - b)), -1.0, 1.0))
    ac_ab_1 = torch.arccos(torch.clamp(
        (lab * lab + lat * lat - lcb * lcb) / (2.0 * lab * lat), -1.0, 1.0))
    ba_bc_1 = torch.arccos(torch.clamp(
        (lab * lab + lcb * lcb - lat * lat) / (2.0 * lab * lcb), -1.0, 1.0))

    r0 = from_angle_axis(ac_ab_1 - ac_ab_0, axis_rot)
    r1 = from_angle_axis(ba_bc_1 - ba_bc_0, axis_rot)

    c_a = normalize(bone_end - bone_root)
    t_a = normalize(target_clamp - bone_root)
    r2 = from_angle_axis(
        torch.arccos(torch.clamp(_dot(c_a, t_a), -1.0, 1.0)),
        normalize(_cross(c_a, t_a)))

    new_root_lr = inv_mul(bone_par_gr, mul(r2, mul(r0, bone_root_gr)))
    new_mid_lr = inv_mul(bone_root_gr, mul(r1, bone_mid_gr))
    return new_root_lr, new_mid_lr
