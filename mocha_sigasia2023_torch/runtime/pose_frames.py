"""Seeded inputs of the frame step's pose math, and the math by each route.

The pose kernels (``ops/pose``) are held to the eager pose math they replace
(``runtime/stream``: ``_roots_eager``, ``_ik_eager``) on these inputs, by
``tests/test_torch_pose_kernels.py`` and by ``chip_smoke.py``'s pose phase:
a walking skeleton whose feet lock, slide off their lock points and reach
past the legs' length, with hip speeds on both sides of the step's guard
(and a non-finite ratio).  Each route carries its own state through
:func:`pose_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kinematics import quat
from ..kinematics.inertial import ContactState
from ..ops import pose
from . import stream

# the featurized 25-joint skeleton (runtime/features: bone_parents) and its
# contact bones (the toes)
PARENTS = (-1, 0, 1, 2, 3, 4, 1, 6, 7, 8, 9, 10, 11, 12, 9, 14, 15, 9, 17,
           18, 19, 1, 21, 22, 23)
CONTACT_BONES = (5, 24)
J = len(PARENTS)
DT = 1.0 / 60.0


def make_plan(ik=stream.IKConfig(), parents=PARENTS, bones=CONTACT_BONES):
    """The kernels' plan for this skeleton, as ``make_stream_step`` makes
    it."""
    return pose.plan(parents, bones, dt=DT, ik_enabled=ik.enabled,
                     max_length_buffer=ik.max_length_buffer,
                     foot_height=ik.foot_height,
                     unlock_radius=ik.unlock_radius,
                     blending_halflife=ik.blending_halflife)


def _offsets():
    off = np.zeros((J, 3), np.float32)
    rng = np.random.default_rng(0)
    off[1:] = rng.uniform(-0.03, 0.03, (J - 1, 3)) + [0.0, 0.1, 0.0]
    for hip, side in ((2, 1.0), (21, -1.0)):
        off[hip] = [0.1 * side, -0.05, 0.0]
        off[hip + 1] = [0.0, -0.42, 0.0]     # knee
        off[hip + 2] = [0.0, -0.42, 0.0]     # heel
        off[hip + 3] = [0.0, -0.06, 0.12]    # toe
    return torch.from_numpy(off)


class Frames:
    """Seeded step inputs for S streams: the frame's x and each stream's
    decoded (pos, rot, vel, ang, speed), made on the CPU, moved to
    ``dev``."""

    def __init__(self, S, seed, dev):
        self.S, self.dev = S, dev
        self.g = torch.Generator().manual_seed(seed)
        self.off = _offsets()
        self.contact = torch.rand(S, 2, generator=self.g) > 0.5

    def _n(self, *shape, scale=1.0):
        return torch.randn(*shape, generator=self.g) * scale

    def _rot(self, S, n, bend):
        q = torch.zeros(S, n, 4)
        q[..., 0] = 1.0
        q[..., 1:] = self._n(S, n, 3, scale=0.08)
        q[..., 1] += bend        # knees bend about x, some nearly straight
        return q / q.norm(dim=-1, keepdim=True)

    def decoded(self):
        """(pos, rot, vel, ang, speed); pos, vel and ang are views of one
        (S, J - 1, 15) block, as the decode's last frame gives them."""
        S = self.S
        block = self._n(S, J - 1, 15, scale=0.2)
        block[..., :3] = self.off[1:] + self._n(S, J - 1, 3, scale=0.005)
        bend = torch.zeros(S, J - 1)
        bend[:, [2, 21]] = torch.rand(S, 2, generator=self.g) * 0.4
        rot = self._rot(S, J - 1, bend)
        speed = torch.rand(S, generator=self.g) * 2.0
        pick = torch.rand(S, generator=self.g)
        speed[pick < 0.1] *= 5.0                 # ratio above 3
        speed[(pick > 0.1) & (pick < 0.2)] *= 0.05   # below 0.33
        speed[(pick > 0.2) & (pick < 0.25)] = 0.0    # 0 / 0 with the source
        block = block.to(self.dev)
        return (block[..., :3], rot.to(self.dev), block[..., 9:12],
                block[..., 12:15], speed.to(self.dev))

    def x(self):
        S = self.S
        flip = torch.rand(S, 2, generator=self.g) < 0.12
        self.contact ^= flip
        hips = 0.5 + torch.rand(S, generator=self.g)
        hips[torch.rand(S, generator=self.g) < 0.05] = 0.0   # non-finite
        rvel = torch.stack([self._n(S, scale=0.2), self._n(S, scale=0.02),
                            1.4 + self._n(S, scale=0.3)], dim=-1)
        rang = torch.stack([self._n(S, scale=0.05), self._n(S, scale=0.6),
                            self._n(S, scale=0.05)], dim=-1)
        pos = self.off.expand(S, J, 3) + self._n(S, J, 3, scale=0.005)
        x = {"rvel_last": rvel, "rang_last": rang, "pos_last": pos,
             "rot_last": self._rot(S, J, torch.zeros(S, J)),
             "vel_last": self._n(S, J, 3, scale=0.3),
             "ang_last": self._n(S, J, 3, scale=0.3),
             "hips_speed_mean": hips,
             "contact_last": self.contact.float()}
        return {k: v.to(self.dev) for k, v in x.items()}

    def carry(self, root_dtype):
        """A first carry: roots at (0, 0.9, 0) facing +z, blends at the
        skeleton's rest pose, contacts unlocked at the rest toes."""
        S, dev = self.S, self.dev
        pos = self.off.expand(S, J, 3).clone()
        pos[:, 0] = torch.tensor([0.0, 0.9, 0.0])
        rot = self._rot(S, J, torch.zeros(S, J))
        _, gpos = quat.fk(rot, pos, PARENTS)
        toes = gpos[:, list(CONTACT_BONES)]
        root = pos[:, 0].to(root_dtype)
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0],
                             dtype=root_dtype).expand(S, 4).clone()
        cs = ContactState.init(toes.to(root_dtype))
        return stream.StreamCarry(
            src_pos0=root.to(dev), src_rot0=ident.to(dev),
            trans_pos0=root.to(dev), trans_prev_pos=pos.to(dev),
            trans_rot0=ident.to(dev), ik_prev_pos=pos.to(dev),
            cm_pos0=root.clone().to(dev), cm_rot0=ident.clone().to(dev),
            prev_cha_encoded=torch.zeros(S, 1, device=dev),
            contacts=ContactState(*(a.to(dev) for a in cs)))


def pose_step(route, plan, ik, carry, x, t, c):
    """The step's pose math by one route ("kernel" or "eager"): (carry,
    outputs) as the step leaves them."""
    if route == "kernel":
        r, out = stream._roots_kernel(plan, carry, x, t, c)
        ik_pos, blended, ik_rot, cs = stream._ik_kernel(plan, carry, x, r,
                                                        out)
    else:
        r = stream._roots_eager(carry, x, t, c, DT)
        ik_pos, blended, ik_rot, cs = stream._ik_eager(
            PARENTS, CONTACT_BONES, ik, DT, carry, x, r)
    new = carry._replace(src_pos0=r.src_pos0, src_rot0=r.src_rot0,
                         trans_pos0=r.trans_pos0, trans_rot0=r.trans_rot0,
                         cm_pos0=r.cm_pos0, cm_rot0=r.cm_rot0,
                         trans_prev_pos=blended, ik_prev_pos=ik_pos,
                         contacts=cs)
    out = {"src_pos": r.src_pos, "src_rot": r.src_rot, "src_vel": r.src_vel,
           "src_ang": r.src_ang, "trans_pos": blended,
           "trans_rot": r.trans_rot, "ik_pos": ik_pos, "ik_rot": ik_rot,
           "cm_pos": r.cm_pos, "cm_rot": r.cm_rot}
    return new, out
