"""Clip -> per-window encoder features, and the dataset feature exports.

Counterpart of mocha_sigasia2023_tpu/runtime/features.py.  The streaming
runtime's path (:126-292, :408, :437, :488): raw clip arrays are featurized
(one batched pass over all clips), world FK runs once per frame, stride-1
windows are gathered from those per-frame arrays in chunks of ``chunk``
windows (128 by default), each chunk is encoded, and only the window-last
rows the stream step reads are derived.  On a card the chunks after the
first are replays of one CUDA graph a call (:func:`_encode_chunks`).
The dataset exports (:40-67, :547-631): ``encode_windows`` over raw
window features in batches of 256, and the database passes behind
``cnt_norm.npz`` (``encode_database``, ``compute_cnt_norm``) and the
per-character feature files (``collect_character_features``), over the
windows ``data.dataset.database_window_features`` selects.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

from ..data.dataset import (compute_window_features,
                            database_window_features, pin_last, window_vel)
from ..data.preprocess import ARRAY_KEYS, featurize_clip
from ..data.windows import padded_window_indices
from ..device import check_module_device, resolve_device
from ..kinematics import quat
from ..models import generator as gen_mod
from ..utils.profiling import span
from . import step_graph

# the encoder's chunk graph (_encode_chunks): captures, replays, and the
# full chunks on a card that went eager instead of to a replay
chunk_captures = 0
chunk_replays = 0
eager_chunks = 0


@torch.no_grad()
def encode_windows(gen, X, norm: Dict[str, np.ndarray], batch: int = 256,
                   device=None):
    """Normalize raw window features X (N, T, J, 15) without the root
    bone and run the embedding + encoder over them, ``batch`` windows at a
    time on ``device``.  Returns (encoded, cnt), (N, tokens, dim) float32
    tensors on the device."""
    dev = resolve_device(device)
    check_module_device(gen, dev, "generator")
    X_mean = torch.as_tensor(norm["X_mean"], dtype=torch.float32, device=dev)
    X_std = torch.as_tensor(norm["X_std"], dtype=torch.float32, device=dev)
    enc_out, cnt_out = [], []
    for i in range(0, len(X), batch):
        xb = torch.as_tensor(np.asarray(X[i:i + batch]), dtype=torch.float32,
                             device=dev)
        x_in = (xb[:, :, 1:] - X_mean[None, None, 1:]) / X_std[None, None, 1:]
        encoded = gen_mod.encode(gen, x_in)
        enc_out.append(encoded)
        cnt_out.append(gen_mod.content_feature(encoded))
    return torch.cat(enc_out), torch.cat(cnt_out)


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


def _chunk_outputs(pf, ci, cp, bone_parents, gen, X_mean, X_std, emit_cnt,
                   compute_dtype):
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
    with span("features.featurize"):
        rot = torch.as_tensor(np.stack([np.asarray(c["rotations"], np.float32)
                                        for c in clips]), device=dev)
        pos = torch.as_tensor(np.stack([np.asarray(c["positions"], np.float32)
                                        for c in clips]), device=dev)
        S, T = rot.shape[:2]
        feats = featurize_clip(rot, pos, c0["order"], c0["names"],
                               c0["parents"], contact_velocity_threshold=0.5,
                               fps=60.0)
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

    out = _encode_chunks(
        lambda ci, cp: _chunk_outputs(pf, ci, cp, bone_parents, gen, X_mean,
                                      X_std, emit_cnt, compute_dtype),
        flat_idx, flat_pad, chunk)
    return {k: v.reshape((S, n_w) + v.shape[1:]) for k, v in out.items()}


def _route(like: torch.Tensor, full_chunks: int) -> str:
    """"graph" for a call whose tensors (``like``) lie on a card, with grad
    off, no capture under way and at least two full chunks; else "eager"
    (a call on a card that went eager counts its full chunks but the
    first in ``eager_chunks``)."""
    global eager_chunks
    if not like.is_cuda or full_chunks < 2:
        return "eager"
    if torch.is_grad_enabled() or torch.cuda.is_current_stream_capturing():
        eager_chunks += full_chunks - 1
        return "eager"
    return "graph"


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of every chunk graph's warm-up and capture on ``device``:
    one a device, since PyTorch keeps a cuBLAS workspace for each stream
    that runs a product, for the life of the process."""
    return torch.cuda.Stream(device)


def _encode_chunks(encode, flat_idx, flat_pad, chunk):
    """``encode(ci, cp)`` over the rows of ``flat_idx`` / ``flat_pad``,
    ``chunk`` at a time, each chunk's outputs copied into its rows of
    outputs allocated once (leading len(flat_idx)).

    On the graph route (:func:`_route`) chunk 0 runs eagerly on the
    device's side stream (:func:`_side_stream`) as the capture's warm-up,
    then ``encode`` is captured there reading static (chunk, window) index
    and pad buffers (``step_graph.Graph``; ``torch.cuda.graph`` waits for
    the device and empties PyTorch's cache of free blocks first), and
    every later full chunk is one replay: its rows copied into the static
    buffers, the replay, its outputs copied out.  A shorter last chunk
    runs eagerly.  The graph lives for the call."""
    global chunk_captures, chunk_replays
    n = len(flat_idx)
    route = _route(flat_idx, n // chunk)
    graph = static = None
    out = {}
    for s in range(0, n, chunk):
        ci, cp = flat_idx[s:s + chunk], flat_pad[s:s + chunk]
        if graph is not None and len(ci) == chunk:
            with span("features.encode", windows=chunk, route="graph"):
                step_graph.copy_tree(static, (ci, cp))
                graph.replay()
                part = graph.out
            chunk_replays += 1
        elif route == "graph" and s == 0:
            side = _side_stream(flat_idx.device)
            with span("features.encode", windows=chunk, route="eager"):
                part = step_graph.warm_up(lambda: encode(ci, cp), side)
            static = (ci.clone(), cp.clone())
            # dense outputs, so that each copy out is one launch
            graph = step_graph.Graph(
                lambda: {k: v.contiguous()
                         for k, v in encode(*static).items()},
                side, counted=False)
            chunk_captures += 1
        else:
            with span("features.encode", windows=len(ci), route="eager"):
                part = encode(ci, cp)
        if not out:
            out = {k: v.new_empty((n,) + v.shape[1:])
                   for k, v in part.items()}
        step_graph.copy_tree([v[s:s + chunk] for v in out.values()],
                             [part[k] for k in out])
    return out


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
    with span("features", streams=len(clips),
              frames=len(clips[0]["rotations"])):
        out = _clip_windows(clips, gen, norm, window, chunk, emit_cnt,
                            compute_dtype, dev)
        frame0 = {k: v[:, 0] for k, v in out.items()}
        xs = {k: v[:, 1:].transpose(0, 1).contiguous()
              for k, v in out.items()}
        return frame0, xs


@torch.no_grad()
def batch_stream_features_ragged(clips: Sequence[Dict], gen, norm, *,
                                 window: int = 60, chunk: int = 128,
                                 emit_cnt: bool = True, compute_dtype=None,
                                 device=None):
    """Featurize + encode clips of mixed lengths: clips are grouped by
    frame count and each group goes through
    :func:`batch_stream_features_device` (grouping is exact; padding raw
    frames would shift the savgol and velocity edge handling).  Each
    group's xs is edge-padded with its last row up to the longest clip's
    window count, and the streams come back in input order.

    Returns ``(frame0, xs, n_windows, n_groups)``: the runner's inputs, each
    clip's true window count (to trim the runner's outputs with) and the
    number of groups."""
    dev = resolve_device(device)
    lengths = [int(np.asarray(c["rotations"]).shape[0]) for c in clips]
    groups: Dict[int, list] = {}
    for i, L in enumerate(lengths):
        groups.setdefault(L, []).append(i)
    n_w = {L: len(padded_window_indices(L, window, 1)[0]) for L in groups}
    w_max = max(n_w.values())

    f0_parts, xs_parts, order = [], [], []
    for L in sorted(groups):
        idxs = groups[L]
        frame0_g, xs_g = batch_stream_features_device(
            [clips[i] for i in idxs], gen, norm, window=window, chunk=chunk,
            emit_cnt=emit_cnt, compute_dtype=compute_dtype, device=dev)
        pad_t = w_max - n_w[L]
        if pad_t:
            xs_g = {k: torch.cat([v, v[-1:].expand((pad_t,) + v.shape[1:])])
                    for k, v in xs_g.items()}
        f0_parts.append(frame0_g)
        xs_parts.append(xs_g)
        order += idxs
    inv = torch.as_tensor(np.argsort(np.asarray(order)), device=dev)
    frame0 = {k: torch.cat([p[k] for p in f0_parts])[inv] for k in f0_parts[0]}
    xs = {k: torch.cat([p[k] for p in xs_parts], dim=1)[:, inv]
          for k in xs_parts[0]}
    return frame0, xs, [n_w[L] for L in lengths], len(groups)


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


def _window_X(db: Dict, idx, device):
    """X features of the database windows at row indices ``idx``."""
    X, _, _ = compute_window_features(
        db["bone_rotations"][idx], db["bone_positions"][idx],
        db["bone_velocities"][idx], db["bone_angular_velocities"][idx],
        db["bone_parents"], device=device)
    return X


def encode_database(db: Dict, gen, norm: Dict[str, np.ndarray], *,
                    window: int = 60, step: int = 20, clip_filter=None,
                    batch: int = 256, device=None):
    """Encode database windows -> (encoded, cnt, styles, actions): encoded
    and cnt (W, tokens, dim) tensors on the device, the labels host
    arrays.  At step 20 this is the dataset pass behind ``cnt_norm.npz``."""
    idx, styles, actions = database_window_features(
        db, window=window, step=step, clip_filter=clip_filter)
    encoded, cnt = encode_windows(gen, _window_X(db, idx, device), norm,
                                  batch=batch, device=device)
    return encoded, cnt, styles, actions


def collect_character_features(db: Dict, gen, norm: Dict[str, np.ndarray],
                               *, style_labels: Sequence[int],
                               action_labels: Sequence[int],
                               window: int = 60, device=None) -> Dict:
    """Per-character sliding-window feature export: encoded/cnt at window
    step 1 over the ranges with one of ``style_labels`` and one of
    ``action_labels``, with each range's start and stop in the export and
    every window's action label, as host arrays.

    A range of T frames gives the T - window windows [j - window, j) for j
    in range(window, T), one fewer than step-1 full windows would (the
    reference export's offset, kept exactly)."""
    starts, stops = db["range_starts"], db["range_stops"]
    styles, actions_sel = set(style_labels), set(action_labels)
    sel_idx, actions = [], []
    out_starts, out_stops = [], []
    for i in range(len(starts)):
        if (int(db["style_labels"][i]) not in styles
                or int(db["action_labels"][i]) not in actions_sel):
            continue
        T = int(stops[i] - starts[i])
        if T <= window:
            continue
        rows = (np.arange(window, T)[:, None] - window
                + np.arange(window)[None, :] + int(starts[i]))
        sel_idx.append(rows.astype(np.int32))
        actions += [int(db["action_labels"][i])] * len(rows)
        off = out_stops[-1] if out_stops else 0
        out_starts.append(off)
        out_stops.append(off + (T - window))
    idx = np.concatenate(sel_idx)
    encoded, cnt = encode_windows(gen, _window_X(db, idx, device), norm,
                                  device=device)
    return {"encoded": encoded.cpu().numpy(), "cnt": cnt.cpu().numpy(),
            "range_starts": np.asarray(out_starts, np.int32),
            "range_stops": np.asarray(out_stops, np.int32),
            "action_label": np.asarray(actions, np.int32)}
