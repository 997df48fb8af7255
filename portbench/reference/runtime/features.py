"""Clip -> per-window encoder features (the streaming runtime's path).

A copy of the port's ``runtime/features.py`` without the dataset exports
(``encode_windows``, ``encode_database``, ``collect_character_features``)
and the ragged batching, which the benchmark does not drive: raw clip
arrays are featurized (one batched pass over all clips), world FK runs
once per frame, stride-1 windows are gathered from those per-frame arrays
in chunks of ``chunk`` windows (128 by default), each chunk is encoded,
and only the window-last rows the stream step reads are derived.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

from ..data.dataset import pin_last, window_vel
from ..data.preprocess import ARRAY_KEYS, featurize_clip
from ..data.windows import padded_window_indices
from ..device import check_module_device, resolve_device
from ..kinematics import quat
from ..models import generator as gen_mod


def _tail_vel(pos4, fps=60.0):
    """window_vel's last row from the window's last 4 rows."""
    inner1 = 0.5 * (pos4[:, 3] - pos4[:, 2]) * fps \
        + 0.5 * (pos4[:, 2] - pos4[:, 1]) * fps
    inner2 = 0.5 * (pos4[:, 2] - pos4[:, 1]) * fps \
        + 0.5 * (pos4[:, 1] - pos4[:, 0]) * fps
    return inner1 + (inner1 - inner2)


def _tail_ang(rot4, fps=60.0):
    """window_ang's last row from the window's last 4 rows."""
    def d(a, b):
        return quat.to_scaled_angle_axis(quat.abs_(quat.mul_inv(a, b)))

    d32 = d(rot4[:, 3], rot4[:, 2])
    d21 = d(rot4[:, 2], rot4[:, 1])
    d10 = d(rot4[:, 1], rot4[:, 0])
    inner1 = 0.5 * d32 * fps + 0.5 * d21 * fps
    inner2 = 0.5 * d21 * fps + 0.5 * d10 * fps
    return inner1 + (inner1 - inner2)


def _per_frame_world(feats, bone_parents):
    """World FK (with velocities) once per frame; window gathers of these
    per-frame arrays are exact because FK is pointwise per frame and linear
    in the local velocities (so pad-zeroing commutes with it)."""
    Grot, Gpos, Gvel, Gang = quat.fk_vel(
        feats["rotations"], feats["positions"], feats["velocities"],
        feats["angular_velocities"], bone_parents)
    rot0 = feats["rotations"][..., 0, :]
    return {"Grot": Grot, "Gpos": Gpos, "Gvel": Gvel, "Gang": Gang,
            "Lrot": feats["rotations"], "Lpos": feats["positions"],
            "Yrvel": quat.inv_mul_vec(rot0, feats["velocities"][..., 0, :]),
            "Yrang": quat.inv_mul_vec(
                rot0, feats["angular_velocities"][..., 0, :]),
            "contacts": feats["contacts"]}


@functools.lru_cache(maxsize=None)
def _root_masks(parents: tuple, device: torch.device):
    """(J, 1) masks of the root joint and of the root's children."""
    par = np.asarray(parents)
    J = len(par)
    return (torch.as_tensor((np.arange(J) == 0).reshape(J, 1), device=device),
            torch.as_tensor(((par == 0) & (np.arange(J) != 0)).reshape(J, 1),
                            device=device))


def _stream_chunk_outputs(pf, ci, cp, bone_parents, gen, X_mean, X_std,
                          emit_cnt=True, compute_dtype=None):
    """One chunk of windows (``ci`` (C, window) row indices into the
    per-frame arrays, ``cp`` their pad mask) -> encoder features + the
    window-last stream rows.  ``compute_dtype`` casts the encoder input;
    encoded and cnt come back float32."""
    is_root, is_rchild = _root_masks(
        tuple(int(p) for p in np.asarray(bone_parents)), ci.device)

    maskf = (~cp).to(torch.float32)
    m = maskf[..., None, None]
    Grot = pin_last(pf["Grot"][ci])
    Gpos = pin_last(pf["Gpos"][ci])
    Gvel = pin_last(pf["Gvel"][ci] * m)
    Gang = pin_last(pf["Gang"][ci] * m)

    root_rot = Grot[:, :, 0:1]
    Xpos = quat.inv_mul_vec(root_rot, Gpos - Gpos[:, :, 0:1])
    Xrot = quat.inv_mul(root_rot, Grot)
    Xvel = quat.inv_mul_vec(root_rot, Gvel)
    Xang = quat.inv_mul_vec(root_rot, Gang)
    b, t, j = Xpos.shape[:3]
    X = torch.cat([Xpos, quat.to_xform_xy(Xrot).reshape(b, t, j, 6), Xvel,
                   Xang], dim=-1)
    x_in = (X[:, :, 1:] - X_mean[None, None, 1:]) / X_std[None, None, 1:]
    if compute_dtype is not None:
        x_in = x_in.to(compute_dtype)
    encoded = gen_mod.encode(gen, x_in)

    # parent-local rows of the last 4 frames only (what the stream reads)
    identq = quat.const([1.0, 0.0, 0.0, 0.0], Xrot)
    ci_t = ci[:, -4:]
    Yrot2_t = torch.where(is_root, identq,
                          torch.where(is_rchild, Xrot[:, -4:],
                                      pf["Lrot"][ci_t]))
    Ypos2_t = torch.where(is_root, 0.0,
                          torch.where(is_rchild, Xpos[:, -4:],
                                      pf["Lpos"][ci_t]))
    hips_vel = window_vel(Xpos[:, :, 1:2])[:, :, 0]

    last_mask = maskf[:, -1]
    last_idx = ci[:, -1]
    out = {"encoded": encoded.float()}
    if emit_cnt:
        out["cnt"] = gen_mod.content_feature(encoded).float()
    out.update({
        "pos_last": Ypos2_t[:, -1],
        "rot_last": quat.from_xform_xy(quat.to_xform_xy(Yrot2_t[:, -1])),
        "vel_last": _tail_vel(Ypos2_t),
        "ang_last": _tail_ang(Yrot2_t),
        "rvel_last": pf["Yrvel"][last_idx] * last_mask[:, None],
        "rang_last": pf["Yrang"][last_idx] * last_mask[:, None],
        "contact_last": pf["contacts"][last_idx].to(torch.float32),
        "hips_speed_mean": torch.mean(
            torch.sqrt(torch.sum(hips_vel * hips_vel, dim=-1)), dim=1),
    })
    return out


def _clip_windows(clips: Sequence[Dict], gen, norm, window, chunk, emit_cnt,
                  compute_dtype, dev) -> Dict[str, torch.Tensor]:
    """Featurize + encode same-length, same-skeleton clips -> per-window
    features with leading (S, n_windows)."""
    c0 = clips[0]
    rot = torch.as_tensor(np.stack([np.asarray(c["rotations"], np.float32)
                                    for c in clips]), device=dev)
    pos = torch.as_tensor(np.stack([np.asarray(c["positions"], np.float32)
                                    for c in clips]), device=dev)
    S, T = rot.shape[:2]
    feats = featurize_clip(rot, pos, c0["order"], c0["names"], c0["parents"],
                           contact_velocity_threshold=0.5, fps=60.0)
    bone_parents = feats["bone_parents"]
    pf = _per_frame_world({k: feats[k] for k in ARRAY_KEYS}, bone_parents)
    pf = {k: v.reshape((S * T,) + v.shape[2:]) for k, v in pf.items()}

    idx, pad = padded_window_indices(T, window, 1)
    n_w = len(idx)
    flat_idx = torch.as_tensor(
        (np.arange(S)[:, None, None] * T + idx[None]).reshape(S * n_w, window),
        dtype=torch.long, device=dev)
    flat_pad = torch.as_tensor(
        np.tile(pad, (S, 1)), device=dev)
    X_mean = torch.as_tensor(norm["X_mean"], dtype=torch.float32, device=dev)
    X_std = torch.as_tensor(norm["X_std"], dtype=torch.float32, device=dev)

    parts = [_stream_chunk_outputs(pf, flat_idx[s:s + chunk],
                                   flat_pad[s:s + chunk], bone_parents, gen,
                                   X_mean, X_std, emit_cnt, compute_dtype)
             for s in range(0, S * n_w, chunk)]
    return {k: torch.cat([p[k] for p in parts]).reshape(
        (S, n_w) + parts[0][k].shape[1:]) for k in parts[0]}


@torch.no_grad()
def batch_stream_features_device(clips: Sequence[Dict], gen, norm, *,
                                 window: int = 60, chunk: int = 128,
                                 emit_cnt: bool = True, compute_dtype=None,
                                 device=None):
    """Featurize + encode many same-length clips and return the
    ``(frame0, xs)`` inputs of :func:`..runtime.stream.make_batch_runner`:
    frame0 leaves (S, ...), xs leaves (T-1, S, ...).  ``compute_dtype``
    runs the encoder in that dtype (give the generator weights of that
    dtype); the features come back float32."""
    dev = resolve_device(device)
    check_module_device(gen, dev, "generator")
    out = _clip_windows(clips, gen, norm, window, chunk, emit_cnt,
                        compute_dtype, dev)
    frame0 = {k: v[:, 0] for k, v in out.items()}
    xs = {k: v[:, 1:].transpose(0, 1).contiguous() for k, v in out.items()}
    return frame0, xs


@torch.no_grad()
def clip_stream_features_device(bvh_data: Dict, gen, norm, *,
                                window: int = 60, chunk: int = 128,
                                emit_cnt: bool = True, compute_dtype=None,
                                device=None) -> Dict:
    """Per-window stream features of one clip: encoded/cnt (N, 90, 256)
    plus the window-last pose rows, with ``bone_parents``/``bone_names``
    (``compute_dtype`` as in :func:`batch_stream_features_device`)."""
    dev = resolve_device(device)
    check_module_device(gen, dev, "generator")
    out = {k: v[0] for k, v in _clip_windows(
        [bvh_data], gen, norm, window, chunk, emit_cnt, compute_dtype,
        dev).items()}
    out["bone_parents"] = np.concatenate(
        [[-1], np.asarray(bvh_data["parents"]) + 1])
    out["bone_names"] = ["Root"] + list(bvh_data["names"])
    return out


def compute_cnt_norm(encoded: torch.Tensor, cnt: torch.Tensor):
    """Context-feature statistics: mean/std over windows per
    (token, channel), on the inputs' device (``cnt_norm.npz`` keeps
    ``mean`` and ``std``)."""
    return {"mean": cnt.mean(dim=0), "std": cnt.std(dim=0, correction=0),
            "encoded_mean": encoded.mean(dim=0),
            "encoded_std": encoded.std(dim=0, correction=0)}
