"""The streaming characterization loop, batched over streams.

Counterpart of mocha_sigasia2023_tpu/runtime/stream.py (the step with its
``compute_cm``, ``compute_dtype``, ``cvae_dtype``, ``fuse_decodes`` and
``lean_decode`` options, ``init_stream``, the batch runner for one
character or a stack of characters with ``runner.chunked``,
``characterize_clip``, ``pad_character_database``, ``cast_database``,
``stack_consts``), of sharded serving (``run_sharded``, JAX's runner on
inputs that ``parallel.shard_streams`` placed) and of ``build_consts`` in
mocha_sigasia2023_tpu/cli/characterize.py:81-112.  Per frame and stream:
nearest-neighbour context match (hoisted out of the frame loop), CVAE prior
sample, two generator decodes, root integration under the velocity-ratio
guard, foot locking with two-bone IK, and the 0.5 blends.

Every tensor carries a leading stream axis S (written out in place of the
JAX package's vmap) and the frame loop is a Python loop (in place of
``lax.scan``).  The step reads the session constants through their stream
view (:func:`stream_consts`): the norms carry a leading axis, 1 for one
character or S gathered by each stream's character, and a character stack's
database is flattened to (C*M) rows that global indices address, so no
stream ever copies a database.  The root integrators and contact springs
run in ``root_dtype`` (float32 by default, float64 allowed — no
process-wide flag is involved); decode, FK and IK stay float32.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import check_module_device, resolve_device
from ..kinematics import quat
from ..kinematics.inertial import ContactState, contact_update
from ..models import cvae as cvae_mod
from ..models import generator as gen_mod
from ..models.layers import batch_shard, current_shard
from ..ops import pose
from ..parallel.mesh import all_gather_rows, data_coordinate
from ..utils.profiling import span
from . import step_graph
from .matching import nn_index, nn_index_grouped


class IKConfig(NamedTuple):
    """Contact/IK constants."""

    enabled: bool = True
    max_length_buffer: float = 0.015
    foot_height: float = 0.02
    toe_length: float = 0.15
    unlock_radius: float = 0.2
    blending_halflife: float = 0.1


class RuntimeConsts(NamedTuple):
    """Per-session tensors: norms and the character database.  A character
    stack (:func:`stack_consts`) gives every field a leading C axis."""

    Y_mean: torch.Tensor            # (J, 15) including root row
    Y_std: torch.Tensor             # (J, 15)
    cha_encoded: torch.Tensor       # (M, tokens, dim) character database
    cha_cnt_flat: torch.Tensor      # (M, tokens*dim) normalized for NN
    cha_cnt_sq: torch.Tensor        # (M,)
    cnt_mean: torch.Tensor          # (tokens, dim)
    cnt_std: torch.Tensor           # (tokens, dim)
    src_cnt_mean: torch.Tensor      # CVAE conditioning norms
    src_cnt_std: torch.Tensor
    cha_encoded_mean: torch.Tensor
    cha_encoded_std: torch.Tensor


# the character database; everything else is a norm
DATABASE_FIELDS = ("cha_encoded", "cha_cnt_flat", "cha_cnt_sq")
# what a database row is padded with: +inf |x|^2 can never win the argmin
PAD_FILL = {"cha_encoded": 0.0, "cha_cnt_flat": 0.0, "cha_cnt_sq": np.inf}


class StreamCarry(NamedTuple):
    """Per-stream carried state, leading axis S."""

    src_pos0: torch.Tensor          # (S, 3) integrated source root position
    src_rot0: torch.Tensor          # (S, 4)
    trans_pos0: torch.Tensor        # (S, 3) CVAE-stream root position
    trans_prev_pos: torch.Tensor    # (S, J, 3) last blended CVAE-stream pose
    trans_rot0: torch.Tensor        # (S, 4)
    ik_prev_pos: torch.Tensor       # (S, J, 3) last IK-blended pose
    cm_pos0: torch.Tensor           # (S, 3) NN-stream root position
    cm_rot0: torch.Tensor           # (S, 4)
    prev_cha_encoded: torch.Tensor  # (S, tokens, dim)
    contacts: ContactState          # (S, 2) contact bones


MATCH_TCHUNK = 32   # frames per pre-loop NN matmul
# elements a frame's packed input starts each tensor at a multiple of, so
# that a graph's step reads each from a 512-byte boundary, as eager reads
# the encodings (step_graph.Rows)
INPUT_ALIGN = 128

FEAT_KEYS = ("encoded", "pos_last", "rot_last", "vel_last", "ang_last",
             "rvel_last", "rang_last", "contact_last", "hips_speed_mean")


def _as_f32(a, dev) -> torch.Tensor:
    """Array or tensor -> float32 tensor on ``dev``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=dev, dtype=torch.float32)


def build_consts(norm, cnt_norm, cvae_norm, cha_feats,
                 device=None) -> RuntimeConsts:
    """Session constants from the X/Y norms, the context-feature norms, the
    optional CVAE norms and the character's stream features (arrays or
    tensors)."""
    dev = resolve_device(device)

    def t(a):
        return _as_f32(a, dev)

    cnt_mean = t(cnt_norm["mean"])
    cnt_std = t(cnt_norm["std"])
    encoded = t(cha_feats["encoded"])
    if cvae_norm is not None:
        temp_weight = t(cvae_norm["std_weight"])
        cnt_std = cnt_std / temp_weight
        src_cnt_mean = t(cvae_norm["src_cnt_mean"])
        src_cnt_std = t(cvae_norm["src_cnt_std"]) / temp_weight
        enc_mean = t(cvae_norm["cha_encoded_mean"])
        enc_std = t(cvae_norm["cha_encoded_std"]) / temp_weight
    else:
        src_cnt_mean, src_cnt_std = cnt_mean, cnt_std
        enc_mean = encoded.mean(dim=0)
        enc_std = encoded.std(dim=0, correction=0) + 1e-6
    cnt = t(cha_feats["cnt"])
    cha_cnt_flat = ((cnt - cnt_mean[None]) / cnt_std[None]).reshape(
        len(cnt), -1)
    return RuntimeConsts(
        Y_mean=t(norm["Y_mean"]), Y_std=t(norm["Y_std"]),
        cha_encoded=encoded, cha_cnt_flat=cha_cnt_flat,
        cha_cnt_sq=torch.sum(cha_cnt_flat ** 2, dim=-1),
        cnt_mean=cnt_mean, cnt_std=cnt_std,
        src_cnt_mean=src_cnt_mean, src_cnt_std=src_cnt_std,
        cha_encoded_mean=enc_mean, cha_encoded_std=enc_std)


def pad_character_database(consts: RuntimeConsts,
                           target_m: int) -> RuntimeConsts:
    """One character's database padded to ``target_m`` rows: zero rows
    whose squared norm is +inf, so the exact NN argmin never picks them."""
    m = consts.cha_encoded.shape[0]
    if m > target_m:
        raise ValueError(f"database has {m} rows > target {target_m}")
    if m == target_m:
        return consts
    return consts._replace(**{
        name: torch.cat([a, a.new_full((target_m - m,) + a.shape[1:],
                                       PAD_FILL[name])])
        for name, a in ((n, getattr(consts, n)) for n in DATABASE_FIELDS)})


def cast_database(consts: RuntimeConsts, dtype) -> RuntimeConsts:
    """The database's encoded rows and normalized cnt matrix stored in
    ``dtype`` (bf16 halves them: 30 characters of 2048 windows are about
    11 GB in float32).  The |x|^2 norms stay float32; gathered encoded rows
    are cast back to float32 where the step uses them, and the score
    product casts one character block at a time (runtime/matching.py)."""
    return consts._replace(cha_encoded=consts.cha_encoded.to(dtype),
                           cha_cnt_flat=consts.cha_cnt_flat.to(dtype))


def stack_consts(consts_list) -> RuntimeConsts:
    """Per-character constants stacked for ``make_batch_runner(...,
    multi_character=True)``: every field gains a leading C axis, and the
    databases are padded to the largest one as
    :func:`pad_character_database` pads them, written straight into the
    stack (no padded copy of each database)."""
    target_m = max(c.cha_encoded.shape[0] for c in consts_list)
    fields = {}
    for name in RuntimeConsts._fields:
        leaves = [getattr(c, name) for c in consts_list]
        if name not in DATABASE_FIELDS:
            fields[name] = torch.stack(leaves)
            continue
        out = leaves[0].new_empty((len(leaves), target_m)
                                  + leaves[0].shape[1:])
        for i, leaf in enumerate(leaves):
            out[i, :len(leaf)] = leaf
            out[i, len(leaf):] = PAD_FILL[name]
        fields[name] = out
    return RuntimeConsts(**fields)


def stream_consts(consts: RuntimeConsts, char_ids=None) -> RuntimeConsts:
    """The constants as the step reads them.  One character
    (``char_ids=None``): the norms gain a leading axis of 1.  A stack: each
    stream's norms are gathered by its character id (S, ...), and the
    database is viewed as (C*M) rows, which global NN indices address."""
    if char_ids is None:
        return consts._replace(**{
            n: getattr(consts, n)[None] for n in RuntimeConsts._fields
            if n not in DATABASE_FIELDS})
    return consts._replace(**{
        n: (getattr(consts, n).flatten(0, 1) if n in DATABASE_FIELDS
            else getattr(consts, n)[char_ids])
        for n in RuntimeConsts._fields})


def stack_stream_inputs(stream_feats: Dict, device=None):
    """Per-clip stream features with leading (S, T) -> (frame0, xs): frame0
    leaves (S, ...), xs leaves (T-1, S, ...), float32 on ``device``."""
    dev = resolve_device(device)
    keys = FEAT_KEYS + (("cnt",) if "cnt" in stream_feats else ())
    frame0, xs = {}, {}
    for k in keys:
        v = _as_f32(stream_feats[k], dev)
        frame0[k] = v[:, 0]
        xs[k] = v[:, 1:].transpose(0, 1).contiguous()
    return frame0, xs


def _decode_frames(gen, consts: RuntimeConsts, src_enc, cha_encs,
                   compute_dtype=None, lean=False):
    """Decode each stream's source window against K character encodings
    (``cha_encs`` (K, S, tokens, dim)) in one generator call and split the
    last frame into pose channels.  ``consts`` is the stream view.  Returns
    K tuples (pos, rot, vel_last, ang, root-joint mean speed over the
    window).  ``compute_dtype`` runs the decoder in that dtype (give the
    generator weights of that dtype); its output is cast to float32 before
    the norms, and the pose math stays float32.  ``lean`` decodes through
    :func:`..models.generator.decode_stream` (the last frame's pose and the
    root joint's velocity track only; the same math)."""
    K, S = cha_encs.shape[:2]
    src = src_enc.expand((K,) + src_enc.shape).flatten(0, 1)
    cha = cha_encs.flatten(0, 1)
    if compute_dtype is not None:
        src, cha = src.to(compute_dtype), cha.to(compute_dtype)
    Y_std, Y_mean = consts.Y_std[:, 1:], consts.Y_mean[:, 1:]
    if lean:
        last, vel0 = gen_mod.decode_stream(gen, src, cha)
        last = (last.float().unflatten(0, (K, S)) * Y_std + Y_mean)
        vel0 = (vel0.float().unflatten(0, (K, S)) * Y_std[:, None, 0, 9:12]
                + Y_mean[:, None, 0, 9:12])
        vel_last = last[..., 9:12]
        hip_vel = vel0
    else:
        Ytil = gen_mod.decode(gen, src, cha).float().unflatten(0, (K, S))
        Ytil = Ytil * Y_std[:, None] + Y_mean[:, None]
        last = Ytil[:, :, -1]
        vel_last = last[..., 9:12]
        hip_vel = Ytil[:, :, :, 0, 9:12]
    pos = last[..., :3]
    rot = quat.from_xform_xy(last[..., 3:9].unflatten(-1, (3, 2)))
    ang = last[..., 12:15]
    hips_speed = torch.mean(
        torch.sqrt(torch.sum(hip_vel * hip_vel, dim=-1)), dim=-1)
    return [(pos[k], rot[k], vel_last[k], ang[k], hips_speed[k])
            for k in range(K)]


def _integrate_root(prev_pos0, prev_rot0, rvel, rang, dt):
    """World-space root integration."""
    rootvel = quat.mul_vec(prev_rot0, rvel)
    rootang = quat.mul_vec(prev_rot0, rang)
    rootpos = prev_pos0 + rootvel * dt
    rootrot = quat.mul(prev_rot0, quat.from_scaled_angle_axis(rootang * dt))
    return rootpos, rootrot, rootvel, rootang


def _guarded_ratio(pred_speed_mean, src_speed_mean):
    """Predicted/source hip-speed ratio, 1 outside [0.33, 3] or non-finite."""
    ratio = pred_speed_mean / src_speed_mean
    bad = (ratio > 3.0) | (ratio < 0.33) | ~torch.isfinite(ratio)
    return torch.where(bad, 1.0, ratio)


def _assemble(rootpos, rootrot, rootvel, rootang, pos, rot, vel, ang):
    """Prepend the integrated root row, cast to the pose dtype."""
    return tuple(torch.cat([r[:, None].to(p.dtype), p], dim=1)
                 for r, p in ((rootpos, pos), (rootrot, rot),
                              (rootvel, vel), (rootang, ang)))


def _set_root(rows, root):
    out = rows.clone()
    out[:, 0] = root.to(rows.dtype)
    return out


def _foot_chains(parents, contact_bones):
    parents = np.asarray(parents)
    toes = np.asarray(contact_bones)
    heels = parents[toes]
    knees = parents[heels]
    hips = parents[knees]
    return toes, heels, knees, hips, parents[hips]


def _ik_fixup(parents, contact_bones, ik: IKConfig, dt,
              contacts: ContactState, bone_pos, bone_rot, input_state):
    """Foot-contact locking + two-bone IK for both feet of every stream,
    from one full-skeleton FK.  Returns (contact state, adjusted rot)."""
    dev = bone_pos.device
    toes, heels, knees, hips, roots = (
        quat.index(a, dev) for a in _foot_chains(parents, contact_bones))
    grot, gpos = quat.fk(bone_rot, bone_pos, parents)

    new_cs = contact_update(
        contacts, gpos[:, toes].to(contacts.position.dtype), input_state,
        ik.unlock_radius, ik.foot_height, ik.blending_halflife, dt)
    p = new_cs.position
    contact_clamped = torch.cat(
        [p[..., 0:1], torch.clamp_min(p[..., 1:2], ik.foot_height),
         p[..., 2:3]], dim=-1)
    target = contact_clamped + (gpos[:, heels] - gpos[:, toes])
    fwd = quat.mul_vec(grot[:, knees], quat.const([0.0, 1.0, 0.0], bone_pos))

    new_hip_lr, new_knee_lr = quat.ik_two_bone(
        bone_rot[:, hips], bone_rot[:, knees],
        gpos[:, hips], gpos[:, knees], gpos[:, heels],
        target, fwd, grot[:, hips], grot[:, knees], grot[:, roots],
        ik.max_length_buffer)
    adjusted = bone_rot.clone()
    adjusted[:, hips] = new_hip_lr.to(bone_rot.dtype)
    adjusted[:, knees] = new_knee_lr.to(bone_rot.dtype)
    return new_cs, adjusted


class PoseRoots(NamedTuple):
    """What the step's root integrations give: the source's rows with its
    integrated root (``src_*``), the decoded CVAE-stream (``trans_*``) and
    NN-stream (``cm_*``) poses with theirs, float32, (S, J, 3|4); and the
    new root carries, (S, 3|4) in the carry's dtype."""

    src_pos: torch.Tensor
    src_rot: torch.Tensor
    src_vel: torch.Tensor
    src_ang: torch.Tensor
    trans_pos: torch.Tensor
    trans_rot: torch.Tensor
    trans_vel: torch.Tensor
    cm_pos: torch.Tensor
    cm_rot: torch.Tensor
    src_pos0: torch.Tensor
    src_rot0: torch.Tensor
    trans_pos0: torch.Tensor
    trans_rot0: torch.Tensor
    cm_pos0: torch.Tensor
    cm_rot0: torch.Tensor


def _roots_eager(carry: StreamCarry, x: Dict, t, c, dt) -> PoseRoots:
    """The step's three root integrations, one launch an operation.  ``t``
    and ``c``: the CVAE and NN streams' decoded (pos, rot, vel, ang,
    speed)."""
    t_pos, t_rot, t_vel, t_ang, t_speed = t
    c_pos, c_rot, c_vel, c_ang, c_speed = c
    # source root integration
    s_rootpos, s_rootrot, s_rootvel, s_rootang = _integrate_root(
        carry.src_pos0, carry.src_rot0, x["rvel_last"], x["rang_last"], dt)
    src_pos = _set_root(x["pos_last"], s_rootpos)
    src_rot = _set_root(x["rot_last"], s_rootrot)
    src_vel = _set_root(x["vel_last"], s_rootvel)
    src_ang = _set_root(x["ang_last"], s_rootang)

    # CVAE/trans stream root integration
    t_ratio = _guarded_ratio(t_speed, x["hips_speed_mean"])
    t_rootpos, t_rootrot, t_rootvel, t_rootang = _integrate_root(
        carry.trans_pos0, carry.trans_rot0,
        x["rvel_last"] * t_ratio[:, None], x["rang_last"], dt)
    trans_pos, trans_rot, trans_vel, _ = _assemble(
        t_rootpos, t_rootrot, t_rootvel, t_rootang,
        t_pos, t_rot, t_vel, t_ang)

    # NN/cm stream root integration
    c_ratio = _guarded_ratio(c_speed, x["hips_speed_mean"])
    c_rootpos, c_rootrot, c_rootvel, c_rootang = _integrate_root(
        carry.cm_pos0, carry.cm_rot0,
        x["rvel_last"] * c_ratio[:, None], x["rang_last"], dt)
    cm_pos, cm_rot, _, _ = _assemble(
        c_rootpos, c_rootrot, c_rootvel, c_rootang,
        c_pos, c_rot, c_vel, c_ang)
    return PoseRoots(src_pos, src_rot, src_vel, src_ang, trans_pos,
                     trans_rot, trans_vel, cm_pos, cm_rot, s_rootpos,
                     s_rootrot, t_rootpos, t_rootrot, c_rootpos, c_rootrot)


def _ik_eager(parents, contact_bones, ik: IKConfig, dt, carry: StreamCarry,
              x: Dict, r: PoseRoots):
    """The blends, and foot locking with IK on the IK blend, one launch an
    operation.  Returns (ik_blend, trans_blended, adjusted rot, contact
    state)."""
    # contact fixup with foot locking + IK on the blended pose
    ik_blend = (0.5 * (carry.ik_prev_pos + r.trans_vel * dt)
                + 0.5 * r.trans_pos)
    if ik.enabled:
        new_cs, adjusted_rot = _ik_fixup(
            parents, contact_bones, ik, dt, carry.contacts, ik_blend,
            r.trans_rot, x["contact_last"] > 0.5)
    else:
        new_cs, adjusted_rot = carry.contacts, r.trans_rot

    trans_blended = (0.5 * (carry.trans_prev_pos + r.trans_vel * dt)
                     + 0.5 * r.trans_pos)
    return ik_blend, trans_blended, adjusted_rot, new_cs


def _roots_kernel(plan: pose.Plan, carry: StreamCarry, x: Dict, t, c):
    """:func:`_roots_eager` as one launch (``ops/pose.pose_roots``).
    Returns (PoseRoots, the step's outputs of both kernels)."""
    r = carry.src_pos0
    out = pose.outputs(plan, r.shape[0], r.dtype, r.device)
    return PoseRoots(*pose.pose_roots(plan, (
        r, carry.src_rot0, carry.trans_pos0, carry.trans_rot0,
        carry.cm_pos0, carry.cm_rot0, x["rvel_last"], x["rang_last"],
        x["pos_last"], x["rot_last"], x["vel_last"], x["ang_last"],
        x["hips_speed_mean"], t[0], t[1], t[2], t[4], c[0], c[1], c[4]),
        out)), out


def _ik_kernel(plan: pose.Plan, carry: StreamCarry, x: Dict, r: PoseRoots,
               out: pose.Outputs):
    """:func:`_ik_eager` as one launch (``ops/pose.pose_ik``), into the
    step's ``out``."""
    ik_blend, trans_blended, adjusted_rot, contact = pose.pose_ik(plan, (
        carry.ik_prev_pos, carry.trans_prev_pos, r.trans_pos, r.trans_vel,
        r.trans_rot, x["contact_last"]) + tuple(carry.contacts), out)
    if contact is None:       # the IK is off
        return ik_blend, trans_blended, r.trans_rot, carry.contacts
    return ik_blend, trans_blended, adjusted_rot, ContactState(*contact)


# the frame's inputs that the pose math reads
X_POSE_KEYS = ("rvel_last", "rang_last", "pos_last", "rot_last", "vel_last",
               "ang_last", "hips_speed_mean", "contact_last")


def _pose_route(plan: Optional[pose.Plan], carry: StreamCarry, x: Dict, t,
                c) -> str:
    """"kernel" where the pose kernels take this step: a skeleton they take
    (``plan``), a carry on a card and tensors :func:`_pose_kernels_take`;
    else "eager": every CPU step, and on a card a step the kernels do not
    take (bf16 poses, another skeleton, tensors to differentiate), which
    ``pose.eager_steps`` counts."""
    if not carry.src_pos0.is_cuda:
        return "eager"
    if plan is not None and _pose_kernels_take(plan, carry, x, t, c):
        return "kernel"
    pose.eager_steps += 1
    return "eager"


def _pose_kernels_take(plan: pose.Plan, carry: StreamCarry, x: Dict, t,
                       c) -> bool:
    """Whether every tensor of the step's pose math lies on the carry's
    device with its S rows and J (decoded: J - 1) joints, the poses in
    float32, the roots and contact vectors in one of float32 and float64,
    the contact flags bool, and none is to be differentiated."""
    r = carry.src_pos0
    if r.dtype not in pose.ROOT_DTYPES:
        return False
    dev, S, J = r.get_device(), r.shape[0], plan.joints
    cs = carry.contacts
    roots = (r, carry.src_rot0, carry.trans_pos0, carry.trans_rot0,
             carry.cm_pos0, carry.cm_rot0) + tuple(cs[2:])
    poses = (carry.ik_prev_pos, carry.trans_prev_pos, t[0], t[1], t[2], t[4],
             c[0], c[1], c[4]) + tuple(x[k] for k in X_POSE_KEYS)
    for group, dtype in ((roots, r.dtype), (poses, torch.float32),
                         (cs[:2], torch.bool)):
        for a in group:
            if a.dtype is not dtype or a.get_device() != dev \
                    or a.shape[0] != S:
                return False
    if (carry.ik_prev_pos.shape[1] != J or carry.trans_prev_pos.shape[1] != J
            or x["pos_last"].shape[1] != J or t[0].shape[1] != J - 1
            or c[0].shape[1] != J - 1):
        return False
    return not (torch.is_grad_enabled()
                and any(a.requires_grad for a in roots + poses))


def make_stream_step(gen, cvae, parents, *, contact_bones=(5, 24),
                     ik: IKConfig = IKConfig(), dt: float = 1.0 / 60.0,
                     deterministic: bool = False, compute_cm: bool = True,
                     compute_dtype=None, cvae_dtype=None,
                     fuse_decodes: bool = False, lean_decode: bool = False):
    """The batched per-frame step: step(consts, carry, x, generator) ->
    (carry, outputs), where ``consts`` is the stream view
    (:func:`stream_consts`), ``x`` holds one frame of stream inputs
    (leading S) and its precomputed ``nn_idx`` (global indices into the
    view's database), and ``generator`` draws the CVAE noise unless
    ``deterministic``.  With ``compute_cm=False`` (serving) the NN-stream
    decode is skipped and the CM outputs are the CVAE stream's.

    ``compute_dtype`` runs the generator decodes in that dtype and
    ``cvae_dtype`` (``compute_dtype`` by default) the CVAE sample, each with
    weights of that dtype; the pose math stays float32.  ``fuse_decodes``
    stacks the two decodes into one K=2 generator call; ``lean_decode``
    decodes only what the step reads.  Both give the same math.

    The pose math after the decodes (the ``stream.roots`` and
    ``stream.ik`` spans) runs as two launches, ``ops/pose``'s kernels,
    where :func:`_pose_route` finds the step's tensors on a card and a
    skeleton the kernels take, and eagerly otherwise (every CPU run); the
    spans' ``route`` attribute says which ("kernel" or "eager").  In a
    runner or a live session on a card, this function runs at the
    session's first step and at the capture of its CUDA graph
    (:mod:`.step_graph`), whose replays run every later step."""
    use_cvae = cvae is not None
    decode_cm = use_cvae and compute_cm
    plan = pose.plan(parents, contact_bones, dt=dt, ik_enabled=ik.enabled,
                     max_length_buffer=ik.max_length_buffer,
                     foot_height=ik.foot_height,
                     unlock_radius=ik.unlock_radius,
                     blending_halflife=ik.blending_halflife)
    if cvae_dtype is None:
        cvae_dtype = compute_dtype

    def decode(consts, src_enc, *chas):
        with span("stream.decode", decodes=len(chas)):
            if fuse_decodes or len(chas) == 1:
                return _decode_frames(gen, consts, src_enc,
                                      torch.stack(chas), compute_dtype,
                                      lean_decode)
            return [_decode_frames(gen, consts, src_enc, c[None],
                                   compute_dtype, lean_decode)[0]
                    for c in chas]

    def step(consts: RuntimeConsts, carry: StreamCarry, x: Dict,
             generator=None):
        idx = x["nn_idx"]
        # the cast covers bf16-stored databases (cast_database)
        nn_cha_encoded = consts.cha_encoded[idx].float()

        if use_cvae:
            with span("stream.cvae"):
                cnt = (x["cnt"] if "cnt" in x
                       else gen_mod.content_feature(x["encoded"]))
                condition = torch.cat(
                    [(cnt - consts.src_cnt_mean) / consts.src_cnt_std,
                     (carry.prev_cha_encoded - consts.cha_encoded_mean)
                     / consts.cha_encoded_std], dim=1)
                if cvae_dtype is not None:
                    condition = condition.to(cvae_dtype)
                vae_out = cvae_mod.sample(cvae, condition,
                                          deterministic=deterministic,
                                          generator=generator).float()
                cvae_cha_encoded = (vae_out * consts.cha_encoded_std
                                    + consts.cha_encoded_mean)
        else:
            cvae_cha_encoded = nn_cha_encoded

        # each stream's decoded (pos, rot, vel, ang, speed)
        if decode_cm:
            t, c = decode(consts, x["encoded"], cvae_cha_encoded,
                          nn_cha_encoded)
        else:
            t, = decode(consts, x["encoded"], cvae_cha_encoded)
            c = t

        route = _pose_route(plan, carry, x, t, c)
        with span("stream.roots", route=route):
            if route == "kernel":
                r, pose_out = _roots_kernel(plan, carry, x, t, c)
            else:
                r = _roots_eager(carry, x, t, c, dt)
        with span("stream.ik", route=route):
            if route == "kernel":
                ik_blend, trans_blended, adjusted_rot, new_cs = _ik_kernel(
                    plan, carry, x, r, pose_out)
            else:
                ik_blend, trans_blended, adjusted_rot, new_cs = _ik_eager(
                    parents, contact_bones, ik, dt, carry, x, r)
        new_carry = StreamCarry(
            src_pos0=r.src_pos0, src_rot0=r.src_rot0,
            trans_pos0=r.trans_pos0, trans_prev_pos=trans_blended,
            trans_rot0=r.trans_rot0, ik_prev_pos=ik_blend,
            cm_pos0=r.cm_pos0, cm_rot0=r.cm_rot0,
            prev_cha_encoded=cvae_cha_encoded, contacts=new_cs)
        outputs = {
            "src_pos": r.src_pos, "src_rot": r.src_rot,
            "src_vel": r.src_vel, "src_ang": r.src_ang,
            "trans_pos": trans_blended, "trans_rot": r.trans_rot,
            "ik_pos": ik_blend, "ik_rot": adjusted_rot,
            "cm_pos": r.cm_pos, "cm_rot": r.cm_rot,
            "contact": x["contact_last"], "nn_index": idx,
        }
        return new_carry, outputs

    return step


def init_stream(gen, consts: RuntimeConsts, parents, frame0: Dict, *,
                contact_bones=(5, 24), dt: float = 1.0 / 60.0,
                root_dtype=torch.float32, compute_dtype=None,
                lean_decode: bool = False):
    """Frame-0 bootstrap of every stream: decode against the NN match
    (``frame0["nn_idx"]``, global indices into the stream view ``consts``),
    identity-root integration, contact state pinned at the decoded toes.
    The decode runs in ``compute_dtype`` (the JAX package's init_stream
    decodes its float32 inputs against the bf16 weights instead, promoting
    in places; the port keeps the whole bf16 session in bf16).  Returns
    (carry, frame-0 outputs)."""
    with span("stream.init"):
        return _init_stream(gen, consts, parents, frame0, contact_bones, dt,
                            root_dtype, compute_dtype, lean_decode)


def _init_stream(gen, consts, parents, frame0, contact_bones, dt,
                 root_dtype, compute_dtype, lean_decode):
    idx = frame0["nn_idx"]
    cha_enc = consts.cha_encoded[idx].float()
    (t_pos, t_rot, t_vel, t_ang, t_speed), = _decode_frames(
        gen, consts, frame0["encoded"], cha_enc[None], compute_dtype,
        lean_decode)

    S = idx.shape[0]
    dev = idx.device
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=root_dtype,
                            device=dev).expand(S, 4)
    zero3 = torch.zeros(S, 3, dtype=root_dtype, device=dev)

    s_rootpos, s_rootrot, s_rootvel, s_rootang = _integrate_root(
        zero3, identity, frame0["rvel_last"], frame0["rang_last"], dt)
    src_pos = _set_root(frame0["pos_last"], s_rootpos)
    src_rot = _set_root(frame0["rot_last"], s_rootrot)
    src_vel = _set_root(frame0["vel_last"], s_rootvel)
    src_ang = _set_root(frame0["ang_last"], s_rootang)

    ratio = _guarded_ratio(t_speed, frame0["hips_speed_mean"])
    t_rootpos, t_rootrot, t_rootvel, t_rootang = _integrate_root(
        zero3, identity, frame0["rvel_last"] * ratio[:, None],
        frame0["rang_last"], dt)
    trans_pos, trans_rot, trans_vel, trans_ang = _assemble(
        t_rootpos, t_rootrot, t_rootvel, t_rootang, t_pos, t_rot, t_vel,
        t_ang)

    toe_pos, toe_vel = [], []
    for b in contact_bones:
        gp, gv, _, _ = quat.fk_vel_bone(trans_rot, trans_pos, trans_vel,
                                        trans_ang, parents, int(b))
        toe_pos.append(gp)
        toe_vel.append(gv)
    cs = ContactState.init(torch.stack(toe_pos, dim=1).to(root_dtype),
                           torch.stack(toe_vel, dim=1).to(root_dtype))

    carry = StreamCarry(
        src_pos0=s_rootpos, src_rot0=s_rootrot,
        trans_pos0=t_rootpos, trans_prev_pos=trans_pos,
        trans_rot0=t_rootrot, ik_prev_pos=trans_pos,
        cm_pos0=t_rootpos, cm_rot0=t_rootrot,
        prev_cha_encoded=cha_enc, contacts=cs)
    outputs = {
        "src_pos": src_pos, "src_rot": src_rot,
        "src_vel": src_vel, "src_ang": src_ang,
        "trans_pos": trans_pos, "trans_rot": trans_rot,
        "ik_pos": trans_pos, "ik_rot": trans_rot,
        "cm_pos": trans_pos, "cm_rot": trans_rot,
        "contact": frame0["contact_last"], "nn_index": idx,
    }
    return carry, outputs


def check_consts_device(consts: RuntimeConsts, dev: torch.device) -> None:
    for name, v in consts._asdict().items():
        if v.device.type != dev.type:
            raise ValueError(f"consts.{name} is on {v.device}, the session "
                             f"on {dev}")


def _layout(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in step_graph.leaves(tree))


class _GraphedSteps:
    """A batch runner's frame steps as one CUDA graph (:mod:`.step_graph`),
    captured from ``step`` after its eager warm-up step (``carry`` and
    ``out_like``, that step's carry and outputs).  The graph reads static
    copies of the stream constants' norms and of the carry, and up to
    ``capacity`` frames of inputs (``frames``: leading n, ``nn_idx``
    included), packed a row a frame and read at a device-side counter;
    it writes each frame's outputs into that frame's row and the new carry
    over the old.  Where the step draws noise (``generator`` given), the
    graph draws from a generator of its own, which takes the caller's
    generator's state before a run's replays and hands the advanced state
    back after them, so that the caller's ends where eager steps leave
    it."""

    def __init__(self, step, sc: RuntimeConsts, carry: StreamCarry,
                 frames: Dict, out_like: Dict, generator, capacity: int,
                 stream):
        dev = carry.src_pos0.device
        self.capacity = capacity
        self.norms = [n for n in RuntimeConsts._fields
                      if n not in DATABASE_FIELDS]
        self.sc = sc._replace(**{n: getattr(sc, n).clone()
                                 for n in self.norms})
        self.carry = step_graph.clone_tree(carry)
        self.inputs = step_graph.Rows({k: v[0] for k, v in frames.items()},
                                      capacity, align=INPUT_ALIGN)
        self.outputs = step_graph.Rows(out_like, capacity)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.generator = (None if generator is None
                          else torch.Generator(device=dev))

        def body():
            x = self.inputs.gather(self.counter)
            new_carry, out = step(self.sc, self.carry, x, self.generator)
            self.outputs.scatter(self.counter, out)
            step_graph.copy_tree(self.carry, new_carry)
            self.counter.add_(1)

        self.graph = step_graph.Graph(body, stream, self.generator)

    def run(self, sc: RuntimeConsts, carry: StreamCarry, frames: Dict,
            generator, start: int, t0: int) -> Dict:
        """Frames ``start``.. of ``frames`` stepped from ``carry``, one
        replay each (``t0``: the first frame's number in the runner call);
        returns their outputs, leading frames - start.  The carry the last
        step made is ``self.carry``."""
        n = len(frames["nn_idx"])
        step_graph.copy_tree([getattr(self.sc, k) for k in self.norms],
                             [getattr(sc, k) for k in self.norms])
        step_graph.copy_tree(self.carry, carry)
        self.inputs.load(frames)
        self.counter.fill_(start)
        if generator is not None:
            self.generator.set_state(generator.get_state())
        for t in range(start, n):
            with span("stream.step", t=t0 + t, route="graph"):
                self.graph.replay()
        if generator is not None:
            generator.set_state(self.generator.get_state())
        return self.outputs.frames(start, n)


def make_batch_runner(gen, cvae, consts: RuntimeConsts, parents, *,
                      contact_bones=(5, 24), ik: IKConfig = IKConfig(),
                      dt: float = 1.0 / 60.0, deterministic: bool = False,
                      compute_cm: bool = True, root_dtype=torch.float32,
                      compute_dtype=None, cvae_dtype=None,
                      fuse_decodes: bool = False, lean_decode: bool = False,
                      multi_character: bool = False, device=None):
    """Batched-streams characterizer.

    Returns ``runner(frame0, xs, generator=None, char_ids=None)`` for frame0
    leaves (S, ...) and xs leaves (T-1, S, ...) (``stack_stream_inputs`` or
    ``batch_stream_features_device``); it returns (T, S, ...) outputs.  The
    NN query depends only on each frame's source features, so every
    (frame, stream) match runs before the frame loop, ``MATCH_TCHUNK``
    frames per matmul, in ``compute_dtype`` when that is set.
    ``generator`` (a ``torch.Generator`` on the device) draws the CVAE
    noise and is required unless ``deterministic``.  ``compute_dtype``,
    ``cvae_dtype``, ``fuse_decodes`` and ``lean_decode`` are the step's
    (:func:`make_stream_step`).

    ``multi_character=True`` serves a different character to each stream
    from one stack (:func:`stack_consts`): the runner then takes
    ``char_ids`` (S,), checked on the host, and matches through
    :func:`..runtime.matching.nn_index_grouped` with G = the largest
    per-character stream count.  ``nn_index`` comes back
    character-local.

    ``runner.chunked(frame0, xs, generator=None, char_ids=None, tchunk=60)``
    takes host-resident inputs and uploads ``tchunk`` frames of xs at a
    time, so the device holds about two chunks of the (T, S, tokens, dim)
    stream instead of all of it; the carry crosses chunk boundaries
    unchanged and the outputs equal the monolithic runner's.

    The frame steps take :func:`.step_graph.route`: on a card (grad is off
    in the runner) the first step of the runner's first call with a given
    layout (streams, dtypes, shard) runs eagerly and the step is captured
    as a CUDA graph; every later step is one replay (the ``stream.step``
    span's ``route`` says "graph" or "eager").  The graph takes a call's xs
    into buffers of its own, so a call holds xs twice on the card.  On the
    CPU every step is eager.
    """
    dev = resolve_device(device)
    check_module_device(gen, dev, "generator")
    if cvae is not None:
        check_module_device(cvae, dev, "cvae")
    check_consts_device(consts, dev)
    parents = tuple(int(p) for p in np.asarray(parents))
    contact_bones = tuple(int(b) for b in contact_bones)
    step = make_stream_step(gen, cvae, parents,
                            contact_bones=contact_bones, ik=ik, dt=dt,
                            deterministic=deterministic,
                            compute_cm=compute_cm,
                            compute_dtype=compute_dtype,
                            cvae_dtype=cvae_dtype, fuse_decodes=fuse_decodes,
                            lean_decode=lean_decode)
    mm_dtype = torch.float32 if compute_dtype is None else compute_dtype
    if consts.cha_cnt_sq.dim() != 1 + multi_character:
        raise ValueError(
            f"runner: consts.cha_cnt_sq has shape "
            f"{tuple(consts.cha_cnt_sq.shape)}; a multi-character runner "
            "takes a stack_consts stack, a single-character one one "
            "character's consts")
    n_characters = consts.cha_cnt_sq.shape[0] if multi_character else 1
    M = consts.cha_cnt_sq.shape[-1]

    def match(sc, cnt, cid, group_size):
        """(Tc, S, tok, dim) cnt -> (Tc, S) global database indices."""
        q = (cnt - sc.cnt_mean) / sc.cnt_std
        q = q.reshape(q.shape[:2] + (-1,))
        if cid is None:
            return nn_index(q, consts.cha_cnt_flat, consts.cha_cnt_sq,
                            mm_dtype)
        return nn_index_grouped(q, consts.cha_cnt_flat, consts.cha_cnt_sq,
                                cid, group_size, mm_dtype)

    def match_frames(sc, f, cid, group_size):
        """(T, S, ...) stream inputs -> (T, S) matches, in time chunks so
        the (T, S, tok, dim) normalized query never materializes whole."""
        src = f["cnt"] if "cnt" in f else f["encoded"]
        with span("stream.match", frames=src.shape[0], streams=src.shape[1]):
            out = []
            for s in range(0, src.shape[0], MATCH_TCHUNK):
                chunk = src[s:s + MATCH_TCHUNK]
                out.append(match(sc, chunk if "cnt" in f
                                 else gen_mod.content_feature(chunk),
                                 cid, group_size))
            return torch.cat(out)

    def check_generator(generator):
        if cvae is not None and not deterministic and generator is None:
            raise ValueError("runner: pass a torch.Generator for the CVAE "
                             "noise, or build with deterministic=True")

    def check_cids(char_ids, S):
        """-> (char ids on the device, group size), or (None, None)."""
        if not multi_character:
            if char_ids is not None:
                raise ValueError("runner: char_ids needs a runner built with "
                                 "multi_character=True")
            return None, None
        if char_ids is None:
            raise ValueError("runner: a multi-character runner needs "
                             "char_ids (S,)")
        cid = np.asarray(char_ids.cpu() if torch.is_tensor(char_ids)
                         else char_ids).astype(np.int64).reshape(-1)
        if len(cid) != S:
            raise ValueError(f"runner: {len(cid)} char_ids for {S} streams")
        # an out-of-range id would index another character's rows
        if cid.size and (cid.min() < 0 or cid.max() >= n_characters):
            raise ValueError(
                f"char_ids must be in [0, {n_characters}); got range "
                f"[{cid.min()}, {cid.max()}] for a {n_characters}-character "
                "consts stack")
        group_size = int(np.bincount(cid, minlength=n_characters).max())
        return torch.as_tensor(cid, device=dev), group_size

    def start(frame0, generator, char_ids):
        check_generator(generator)
        cid, group_size = check_cids(char_ids, len(frame0["encoded"]))
        sc = stream_consts(consts, cid)
        idx0 = match_frames(sc, {k: v[None] for k, v in frame0.items()},
                            cid, group_size)[0]
        carry, out0 = init_stream(gen, sc, parents,
                                  dict(frame0, nn_idx=idx0),
                                  contact_bones=contact_bones, dt=dt,
                                  root_dtype=root_dtype,
                                  compute_dtype=compute_dtype,
                                  lean_decode=lean_decode)
        return (sc, cid, group_size), carry, [_frames(out0)]

    graphs = {}     # _GraphedSteps by the layout of what the step reads

    def scan(session, carry, xs, generator, outs):
        """The step over xs's frames; appends their outputs to ``outs``
        (blocks with a leading frame axis) and returns the last carry."""
        sc, cid, group_size = session
        idx_xs = match_frames(sc, xs, cid, group_size)
        n = idx_xs.shape[0]
        t0 = sum(len(o["nn_index"]) for o in outs)
        if n and step_graph.route(carry.src_pos0, n) == "graph":
            return scan_graph(sc, carry, dict(xs, nn_idx=idx_xs), generator,
                              outs, t0)
        for t in range(n):
            x = {k: v[t] for k, v in xs.items()}
            x["nn_idx"] = idx_xs[t]
            with span("stream.step", t=t0 + t, route="eager"):
                carry, o = step(sc, carry, x, generator)
            outs.append(_frames(o))
        return carry

    def scan_graph(sc, carry, frames, generator, outs, t0):
        n = len(frames["nn_idx"])
        x = {k: v[0] for k, v in frames.items()}
        # a generator the graph draws from, if the step draws noise
        noise = None if cvae is None or deterministic else generator
        key = (current_shard(), noise is None, tuple(x), _layout(x),
               _layout(carry))
        steps = graphs.get(key)
        start = 0
        if steps is None or steps.capacity < n:
            graphs.pop(key, None)     # its buffers go before the new ones
            side = torch.cuda.Stream(dev)     # the warm-up's and capture's
            with span("stream.step", t=t0, route="eager"):
                carry, o = step_graph.warm_up(
                    lambda: step(sc, carry, x, generator), side)
            outs.append(_frames(o))
            start = 1
            steps = graphs[key] = _GraphedSteps(step, sc, carry, frames, o,
                                                noise, n, side)
        if start < n:
            outs.append(steps.run(sc, carry, frames, noise, start, t0))
        return steps.carry

    def finish(session, outs):
        with span("stream.finish"):
            out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
            cid = session[1]
            if cid is not None:   # character-local, as a dedicated runner's
                out["nn_index"] = out["nn_index"] - cid * M
            return out

    batches = itertools.count()   # the request id of each call's spans

    @torch.no_grad()
    def runner(frame0: Dict, xs: Dict,
               generator: Optional[torch.Generator] = None,
               char_ids=None) -> Dict[str, torch.Tensor]:
        S = len(frame0["encoded"])
        T = 1 + len(xs["encoded"])
        with span("stream.runner", request=next(batches), streams=S,
                  frames=T):
            session, carry, outs = start(frame0, generator, char_ids)
            scan(session, carry, xs, generator, outs)
            return finish(session, outs)

    def upload(a):
        """Host array or tensor -> float32 on the device; CUDA copies go
        from pinned memory without blocking the host."""
        a = torch.as_tensor(a, dtype=torch.float32)
        if dev.type == "cuda":
            return a.pin_memory().to(dev, non_blocking=True)
        return a.to(dev)

    @torch.no_grad()
    def chunked(frame0: Dict, xs: Dict,
                generator: Optional[torch.Generator] = None, char_ids=None,
                tchunk: int = 60) -> Dict[str, torch.Tensor]:
        if tchunk < 1:
            raise ValueError(f"chunked: tchunk must be >= 1, got {tchunk}")
        T = len(next(iter(xs.values())))
        with span("stream.runner", request=next(batches),
                  streams=len(frame0["encoded"]), frames=1 + T):
            session, carry, outs = start(
                {k: upload(v) for k, v in frame0.items()}, generator,
                char_ids)
            for s in range(0, T, tchunk):
                carry = scan(session, carry, {k: upload(v[s:s + tchunk])
                                              for k, v in xs.items()},
                             generator, outs)
            return finish(session, outs)

    runner.chunked = chunked
    return runner


def _frames(out: Dict) -> Dict:
    """One frame's outputs as a block of one frame."""
    return {k: v[None] for k, v in out.items()}


def run_sharded(runner, mesh, frame0: Dict, xs: Dict,
                generator: Optional[torch.Generator] = None,
                char_ids=None) -> Dict[str, torch.Tensor]:
    """Sharded serving: ``runner`` (:func:`make_batch_runner`) over this
    rank's block of the S streams, the outputs gathered in stream order on
    every rank, (T, S, ...).  ``frame0`` / ``xs`` (and ``char_ids``) hold
    the rank's block: ``parallel.shard_streams`` of the global inputs, or
    the features of ``parallel.shard_batch``'s block of the clips.  The
    streams are independent, so no rank waits on another until the
    gather.  The CVAE noise of each frame is drawn for all S streams and
    cut to the rank's rows (``layers.batch_shard``): every stream gets the
    noise the unsharded run with the same ``generator`` seed gives it."""
    index, count = data_coordinate(mesh)
    with batch_shard(index, count):
        out = runner(frame0, xs, generator, char_ids=char_ids)
    return {k: all_gather_rows(v, mesh, dim=1) for k, v in out.items()}


def characterize_clip(gen, cvae, consts: RuntimeConsts, parents,
                      stream_feats: Dict, *, contact_bones=(5, 24),
                      ik: IKConfig = IKConfig(), dt: float = 1.0 / 60.0,
                      deterministic: bool = False, compute_cm: bool = True,
                      compute_dtype=None, cvae_dtype=None,
                      fuse_decodes: bool = False, lean_decode: bool = False,
                      root_dtype=torch.float64,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[str, np.ndarray]:
    """Characterize one clip: the frame-0 init, then the step over the
    remaining frames.  ``stream_feats`` holds the clip's per-window stream
    features with leading T (``clip_stream_features_device``).  Roots
    integrate in float64 by default (the offline path, with the long-horizon
    1e-3 bound).  ``generator`` draws the CVAE noise; by default one seeded
    with 1777 on the device.  Returns NumPy arrays (T, ...)."""
    dev = resolve_device(device)
    feats = {k: v[None] for k, v in stream_feats.items()
             if k in FEAT_KEYS or k == "cnt"}
    frame0, xs = stack_stream_inputs(feats, device=dev)
    runner = make_batch_runner(gen, cvae, consts, parents,
                               contact_bones=contact_bones, ik=ik, dt=dt,
                               deterministic=deterministic,
                               compute_cm=compute_cm, root_dtype=root_dtype,
                               compute_dtype=compute_dtype,
                               cvae_dtype=cvae_dtype,
                               fuse_decodes=fuse_decodes,
                               lean_decode=lean_decode, device=dev)
    if generator is None and not deterministic:
        generator = torch.Generator(device=dev).manual_seed(1777)
    out = runner(frame0, xs, generator)
    return {k: v[:, 0].cpu().numpy() for k, v in out.items()}
