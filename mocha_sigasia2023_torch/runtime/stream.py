"""The streaming characterization loop, batched over streams.

Counterpart of mocha_sigasia2023_tpu/runtime/stream.py (default step,
``compute_cm``, the single-character batch runner with ``runner.chunked``,
``characterize_clip``; no fused or lean decodes, no bf16 modes) and of
``build_consts`` in
mocha_sigasia2023_tpu/cli/characterize.py:81-112.  Per frame and stream:
nearest-neighbour context match (hoisted out of the frame loop), CVAE prior
sample, two generator decodes, root integration under the velocity-ratio
guard, foot locking with two-bone IK, and the 0.5 blends.

Every tensor carries a leading stream axis S (written out in place of the
JAX package's vmap) and the frame loop is a Python loop (in place of
``lax.scan``).  The root integrators and contact springs run in
``root_dtype`` (float32 by default, float64 allowed — no process-wide flag
is involved); decode, FK and IK stay float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import check_module_device, resolve_device
from ..kinematics import quat
from ..kinematics.inertial import ContactState, contact_update
from ..models import cvae as cvae_mod
from ..models import generator as gen_mod
from .matching import nn_index


class IKConfig(NamedTuple):
    """Contact/IK constants."""

    enabled: bool = True
    max_length_buffer: float = 0.015
    foot_height: float = 0.02
    toe_length: float = 0.15
    unlock_radius: float = 0.2
    blending_halflife: float = 0.1


class RuntimeConsts(NamedTuple):
    """Per-session tensors: norms and the character database."""

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


def _decode_frame(gen, consts: RuntimeConsts, src_enc, cha_enc):
    """Decode each stream's source window against its character encoding
    and split the last frame into pose channels.  Returns (pos, rot,
    vel_last, ang, root-joint mean speed over the window)."""
    S = src_enc.shape[0]
    Ytil = gen_mod.decode(gen, src_enc, cha_enc)
    Ytil = Ytil * consts.Y_std[1:] + consts.Y_mean[1:]
    pos = Ytil[:, -1, :, :3]
    txy = Ytil[:, -1, :, 3:9].reshape(S, -1, 3, 2)
    vel_full = Ytil[..., 9:12]
    ang = Ytil[:, -1, :, 12:15]
    hip_vel = vel_full[:, :, 0]
    hips_speed = torch.mean(torch.sqrt(torch.sum(hip_vel * hip_vel, dim=-1)),
                            dim=-1)
    return pos, quat.from_xform_xy(txy), vel_full[:, -1], ang, hips_speed


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


def make_stream_step(gen, cvae, consts: RuntimeConsts, parents, *,
                     contact_bones=(5, 24), ik: IKConfig = IKConfig(),
                     dt: float = 1.0 / 60.0, deterministic: bool = False,
                     compute_cm: bool = True):
    """The batched per-frame step: step(carry, x, generator) -> (carry,
    outputs), where ``x`` holds one frame of stream inputs (leading S) and
    its precomputed ``nn_idx``; ``generator`` draws the CVAE noise unless
    ``deterministic``.  With ``compute_cm=False`` (serving) the NN-stream
    decode is skipped and the CM outputs are the CVAE stream's."""
    use_cvae = cvae is not None
    decode_cm = use_cvae and compute_cm

    def step(carry: StreamCarry, x: Dict, generator=None):
        idx = x["nn_idx"]
        nn_cha_encoded = consts.cha_encoded[idx]

        if use_cvae:
            cnt = (x["cnt"] if "cnt" in x
                   else gen_mod.content_feature(x["encoded"]))
            condition = torch.cat(
                [(cnt - consts.src_cnt_mean) / consts.src_cnt_std,
                 (carry.prev_cha_encoded - consts.cha_encoded_mean)
                 / consts.cha_encoded_std], dim=1)
            vae_out = cvae_mod.sample(cvae, condition,
                                      deterministic=deterministic,
                                      generator=generator)
            cvae_cha_encoded = (vae_out * consts.cha_encoded_std
                                + consts.cha_encoded_mean)
        else:
            cvae_cha_encoded = nn_cha_encoded

        t_pos, t_rot, t_vel, t_ang, t_speed = _decode_frame(
            gen, consts, x["encoded"], cvae_cha_encoded)
        if decode_cm:
            c_pos, c_rot, c_vel, c_ang, c_speed = _decode_frame(
                gen, consts, x["encoded"], nn_cha_encoded)
        else:
            c_pos, c_rot, c_vel, c_ang, c_speed = (
                t_pos, t_rot, t_vel, t_ang, t_speed)

        # source root integration
        s_rootpos, s_rootrot, s_rootvel, s_rootang = _integrate_root(
            carry.src_pos0, carry.src_rot0, x["rvel_last"], x["rang_last"],
            dt)
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

        # contact fixup with foot locking + IK on the blended pose
        ik_blend = 0.5 * (carry.ik_prev_pos + trans_vel * dt) + 0.5 * trans_pos
        if ik.enabled:
            new_cs, adjusted_rot = _ik_fixup(
                parents, contact_bones, ik, dt, carry.contacts, ik_blend,
                trans_rot, x["contact_last"] > 0.5)
        else:
            new_cs, adjusted_rot = carry.contacts, trans_rot

        trans_blended = (0.5 * (carry.trans_prev_pos + trans_vel * dt)
                         + 0.5 * trans_pos)
        new_carry = StreamCarry(
            src_pos0=s_rootpos, src_rot0=s_rootrot,
            trans_pos0=t_rootpos, trans_prev_pos=trans_blended,
            trans_rot0=t_rootrot, ik_prev_pos=ik_blend,
            cm_pos0=c_rootpos, cm_rot0=c_rootrot,
            prev_cha_encoded=cvae_cha_encoded, contacts=new_cs)
        outputs = {
            "src_pos": src_pos, "src_rot": src_rot,
            "src_vel": src_vel, "src_ang": src_ang,
            "trans_pos": trans_blended, "trans_rot": trans_rot,
            "ik_pos": ik_blend, "ik_rot": adjusted_rot,
            "cm_pos": cm_pos, "cm_rot": cm_rot,
            "contact": x["contact_last"], "nn_index": idx,
        }
        return new_carry, outputs

    return step


def init_stream(gen, consts: RuntimeConsts, parents, frame0: Dict, *,
                contact_bones=(5, 24), dt: float = 1.0 / 60.0,
                root_dtype=torch.float32):
    """Frame-0 bootstrap of every stream: decode against the NN match
    (``frame0["nn_idx"]``), identity-root integration, contact state pinned
    at the decoded toes.  Returns (carry, frame-0 outputs)."""
    idx = frame0["nn_idx"]
    cha_enc = consts.cha_encoded[idx]
    t_pos, t_rot, t_vel, t_ang, t_speed = _decode_frame(
        gen, consts, frame0["encoded"], cha_enc)

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


def make_batch_runner(gen, cvae, consts: RuntimeConsts, parents, *,
                      contact_bones=(5, 24), ik: IKConfig = IKConfig(),
                      dt: float = 1.0 / 60.0, deterministic: bool = False,
                      compute_cm: bool = True, root_dtype=torch.float32,
                      device=None):
    """Batched-streams characterizer for one character.

    Returns ``runner(frame0, xs, generator=None)`` for frame0 leaves
    (S, ...) and xs leaves (T-1, S, ...) (``stack_stream_inputs`` or
    ``batch_stream_features_device``); it returns (T, S, ...) outputs.  The
    NN query depends only on each frame's source features, so every
    (frame, stream) match runs before the frame loop, ``MATCH_TCHUNK``
    frames per matmul.  ``generator`` (a ``torch.Generator`` on the
    device) draws the CVAE noise and is required unless ``deterministic``.

    ``runner.chunked(frame0, xs, generator=None, tchunk=60)`` takes
    host-resident inputs and uploads ``tchunk`` frames of xs at a time, so
    the device holds about two chunks of the (T, S, tokens, dim) stream
    instead of all of it; the carry crosses chunk boundaries unchanged and
    the outputs equal the monolithic runner's.
    """
    dev = resolve_device(device)
    check_module_device(gen, dev, "generator")
    if cvae is not None:
        check_module_device(cvae, dev, "cvae")
    for name, v in consts._asdict().items():
        if v.device.type != dev.type:
            raise ValueError(f"consts.{name} is on {v.device}, the runner on "
                             f"{dev}")
    parents = tuple(int(p) for p in np.asarray(parents))
    contact_bones = tuple(int(b) for b in contact_bones)
    step = make_stream_step(gen, cvae, consts, parents,
                            contact_bones=contact_bones, ik=ik, dt=dt,
                            deterministic=deterministic,
                            compute_cm=compute_cm)

    def match(cnt):
        """(Tc, S, tok, dim) cnt -> (Tc, S) database indices."""
        q = (cnt - consts.cnt_mean) / consts.cnt_std
        return nn_index(q.reshape(q.shape[:2] + (-1,)), consts.cha_cnt_flat,
                        consts.cha_cnt_sq)

    def match_frames(f):
        """(T, S, ...) stream inputs -> (T, S) matches, in time chunks so
        the (T, S, tok, dim) normalized query never materializes whole."""
        src = f["cnt"] if "cnt" in f else f["encoded"]
        out = []
        for s in range(0, src.shape[0], MATCH_TCHUNK):
            chunk = src[s:s + MATCH_TCHUNK]
            out.append(match(chunk if "cnt" in f
                             else gen_mod.content_feature(chunk)))
        return torch.cat(out)

    def check_generator(generator):
        if cvae is not None and not deterministic and generator is None:
            raise ValueError("runner: pass a torch.Generator for the CVAE "
                             "noise, or build with deterministic=True")

    def start(frame0):
        idx0 = match_frames({k: v[None] for k, v in frame0.items()})[0]
        return init_stream(gen, consts, parents, dict(frame0, nn_idx=idx0),
                           contact_bones=contact_bones, dt=dt,
                           root_dtype=root_dtype)

    def scan(carry, xs, generator, outs):
        """The step over xs's frames, appending each frame's outputs."""
        idx_xs = match_frames(xs)
        for t in range(idx_xs.shape[0]):
            x = {k: v[t] for k, v in xs.items()}
            x["nn_idx"] = idx_xs[t]
            carry, o = step(carry, x, generator)
            outs.append(o)
        return carry

    def stack(outs):
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    @torch.no_grad()
    def runner(frame0: Dict, xs: Dict, generator: Optional[torch.Generator]
               = None) -> Dict[str, torch.Tensor]:
        check_generator(generator)
        carry, out0 = start(frame0)
        outs = [out0]
        scan(carry, xs, generator, outs)
        return stack(outs)

    def upload(a):
        """Host array or tensor -> float32 on the device; CUDA copies go
        from pinned memory without blocking the host."""
        a = torch.as_tensor(a, dtype=torch.float32)
        if dev.type == "cuda":
            return a.pin_memory().to(dev, non_blocking=True)
        return a.to(dev)

    @torch.no_grad()
    def chunked(frame0: Dict, xs: Dict,
                generator: Optional[torch.Generator] = None,
                tchunk: int = 60) -> Dict[str, torch.Tensor]:
        check_generator(generator)
        if tchunk < 1:
            raise ValueError(f"chunked: tchunk must be >= 1, got {tchunk}")
        T = len(next(iter(xs.values())))
        carry, out0 = start({k: upload(v) for k, v in frame0.items()})
        outs = [out0]
        for s in range(0, T, tchunk):
            carry = scan(carry, {k: upload(v[s:s + tchunk])
                                 for k, v in xs.items()}, generator, outs)
        return stack(outs)

    runner.chunked = chunked
    return runner


def characterize_clip(gen, cvae, consts: RuntimeConsts, parents,
                      stream_feats: Dict, *, contact_bones=(5, 24),
                      ik: IKConfig = IKConfig(), dt: float = 1.0 / 60.0,
                      deterministic: bool = False, compute_cm: bool = True,
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
                               device=dev)
    if generator is None and not deterministic:
        generator = torch.Generator(device=dev).manual_seed(1777)
    out = runner(frame0, xs, generator)
    return {k: v[:, 0].cpu().numpy() for k, v in out.items()}
