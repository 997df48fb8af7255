"""Live characterization: one ``runtime/live.LiveCharacterizer`` session
with the class's defaults (seeded CVAE noise, float32 roots, both
decodes), in a closed loop: each frame is pushed when the last pose has
come back to the host.

Set-up makes the per-frame features of one synthetic clip (as the port's
``clip_stream_features_device`` makes them), bootstraps the session on
frame 0 and warms it up; the window then cycles through the clip's frames
without resetting the session, so no bootstrap frame falls inside it.

Mix parameters: ``clip_frames``, ``pad``, ``warmup_frames``,
``profile_frames`` (pushed under the profiler at the start of a traced
window), ``window_frames`` (optional: the window also ends at that many
timed frames, so the check's replay of every served frame stays bounded
however fast the program serves), and the character's as in
``offline.py`` (``characters`` 1).
"""

from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import PROGRAM
from ..seeds import subseed
from ..trace import Spans, Trace, profile_slice
from . import common
from .offline import build_characters

END_TO_END = {"frame_latency_p95_ms": "ms"}
POS_KEYS = ("src_pos", "trans_pos", "ik_pos", "cm_pos")
ROT_KEYS = ("src_rot", "trans_rot", "cm_rot")   # ik_rot: see offline.py
FEAT_KEYS = ("encoded", "cnt", "pos_last", "rot_last", "vel_last",
             "ang_last", "rvel_last", "rang_last", "contact_last",
             "hips_speed_mean")
OUT_KEYS = POS_KEYS + ROT_KEYS + ("ik_rot", "nn_index")


def live_clip(mix, seed):
    return common.source_clip(seed, "live clip", int(mix["clip_frames"]),
                              int(mix["pad"]))


class PlainLive:
    """The reference's stream step served as a live session, frame by frame
    (the control's stand-in for the port's ``runtime/live``, and the
    check's replay): a frame's features uploaded, matched unless
    ``nn_idx`` gives the pick, stepped, and its pose copied back."""

    def __init__(self, impl, gen, cvae, consts, parents, dev, generator):
        self.impl, self.gen, self.dev = impl, gen, dev
        self.consts, self.sc = consts, impl.stream.stream_consts(consts)
        self.parents = tuple(int(p) for p in parents)
        self.step = impl.stream.make_stream_step(gen, cvae, self.parents)
        self.generator, self.carry = generator, None

    @torch.no_grad()
    def push_frame(self, row, nn_idx=None):
        x = {k: torch.as_tensor(np.asarray(row[k], np.float32))[None].to(
            self.dev) for k in FEAT_KEYS}
        if nn_idx is None:
            q = (x["cnt"] - self.sc.cnt_mean) / self.sc.cnt_std
            x["nn_idx"] = self.impl.matching.nn_index(
                q.reshape(1, -1), self.consts.cha_cnt_flat,
                self.consts.cha_cnt_sq)
        else:
            x["nn_idx"] = torch.as_tensor([int(nn_idx)], device=self.dev)
        if self.carry is None:
            self.carry, out = self.impl.stream.init_stream(
                self.gen, self.sc, self.parents, x)
        else:
            self.carry, out = self.step(self.sc, self.carry, x,
                                        self.generator)
        return {k: out[k][0].cpu().numpy() for k in OUT_KEYS}


class Session:
    def __init__(self, impl, cell, seed, dev):
        mix = cell.mix
        self.mix, self.dev = mix, dev
        with common.stage("set-up: models", dev):
            self.gen, self.cvae = common.serving_models(impl, cell.config,
                                                        seed, dev)
        with common.stage("set-up: character", dev):
            norm, consts, parents = build_characters(impl, self.gen, mix,
                                                     seed, dev)
        with common.stage("set-up: clip features", dev):
            feats = impl.features.clip_stream_features_device(
                live_clip(mix, seed), self.gen, norm,
                window=self.gen.cfg.nframes, device=dev)
            host = {k: feats[k].cpu().numpy() for k in FEAT_KEYS}
        self.rows = [{k: host[k][i] for k in FEAT_KEYS}
                     for i in range(len(host["encoded"]))]
        self.noise_seed = subseed(seed, "live noise")
        generator = torch.Generator(device=dev).manual_seed(self.noise_seed)
        if impl.name == PROGRAM:
            live_mod = importlib.import_module(f"{impl.name}.runtime.live")
            self.live = live_mod.LiveCharacterizer(
                self.gen, self.cvae, consts, parents, device=dev,
                generator=generator)
        else:     # the control puts the reference's session in its place
            self.live = PlainLive(impl, self.gen, self.cvae, consts,
                                  parents, dev, generator)
        self.outs: List[Dict[str, np.ndarray]] = []

    def push(self) -> None:
        """Push the next frame of the cycle; keep its pose."""
        row = self.rows[len(self.outs) % len(self.rows)]
        self.outs.append(self.live.push_frame(row))


def setup(cell, seed, dev, impl):
    session = Session(impl, cell, seed, dev)
    with common.stage("set-up: bootstrap and warm-up frames", dev):
        for _ in range(1 + int(cell.mix["warmup_frames"])):
            session.push()
    return session


def window(cell, session: Session, seconds: float, traced: bool):
    """Push frames until one ends at or past ``seconds`` or the mix's
    ``window_frames``-th has been timed, whichever comes first (a traced
    run's profiled frames come before and count toward neither)."""
    mix, dev = cell.mix, session.dev
    cap = mix.get("window_frames")
    first = len(session.outs)
    slice_ = None
    if traced:
        n = int(mix["profile_frames"])

        def frames():
            for _ in range(n):
                session.push()

        _, slice_ = profile_slice(frames, dev, frames=n)
    latencies = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        session.push()
        te = time.perf_counter()
        latencies.append(te - ts)
        if cap is not None and len(latencies) >= int(cap):
            ended_by = "cap"
            break
        if te - t0 >= seconds:
            ended_by = "clock"
            break
    pushed = session.outs[first:]
    failed = sum(1 for o in pushed
                 if not all(np.isfinite(o[k]).all()
                            for k in POS_KEYS + ROT_KEYS + ("ik_rot",)))
    e2e = {"frame_latency_p95_ms":
           1e3 * float(np.percentile(np.asarray(latencies), 95))}
    trace = None
    if traced:
        trace = Trace(kind="live", mix=mix, slice=slice_, spans=Spans(dev))
    return {"attempted": len(pushed), "failed": failed, "e2e": e2e,
            "trace": trace, "outs": session.outs,
            "rows": len(session.rows), "noise_seed": session.noise_seed,
            "window_frames": len(latencies), "ended_by": ended_by}


def release(session: Session) -> None:
    session.live = session.gen = session.cvae = None


@torch.no_grad()
def check(cell, seed, dev, record, limits) -> Dict[str, float]:
    """Every frame the session served, set-up's included, worked out again
    by the plain reference: the same clip featurized, the program's picks
    judged by their distance gap, then the session replayed frame by frame
    on those picks with the same noise, every pose and rotation
    compared."""
    from ..harness import implementation

    ref = implementation("portbench.reference")
    mix = cell.mix
    outs = record["outs"]
    gen, cvae = common.serving_models(ref, cell.config, seed, dev)
    norm, consts, parents = build_characters(ref, gen, mix, seed, dev)
    feats = ref.features.clip_stream_features_device(
        live_clip(mix, seed), gen, norm, window=gen.cfg.nframes, device=dev)
    rows = np.arange(len(outs)) % record["rows"]   # frame i pushed row i % n
    order = torch.as_tensor(rows, device=dev)
    picks = torch.as_tensor(np.array([o["nn_index"] for o in outs]),
                            device=dev)
    q = ((feats["cnt"] - consts.cnt_mean) / consts.cnt_std).flatten(-2)
    gaps = ref.matching.pick_gaps(
        q[order][:, None], consts.cha_cnt_flat[None],
        consts.cha_cnt_sq[None], torch.zeros(1, dtype=torch.int64,
                                             device=dev), picks[:, None])

    picks = picks.clamp(0, consts.cha_cnt_sq.shape[-1] - 1)  # see offline
    generator = torch.Generator(device=dev).manual_seed(
        record["noise_seed"])
    replay = PlainLive(ref, gen, cvae, consts, parents, dev, generator)
    host = {k: feats[k].cpu().numpy() for k in FEAT_KEYS}
    keys = POS_KEYS + ROT_KEYS + ("ik_rot",)
    got = []
    t0 = time.perf_counter()
    with common.stage("check: reference replay", dev):
        for i in range(len(outs)):
            r = int(rows[i])
            got.append(replay.push_frame({k: host[k][r] for k in FEAT_KEYS},
                                         nn_idx=picks[i]))
    replay_s = time.perf_counter() - t0
    print(f"[portbench] live window: {record['window_frames']} frames, "
          f"ended by the {record['ended_by']} (window_frames "
          f"{mix.get('window_frames')}); replay: {len(outs)} frames in "
          f"{replay_s:.3f} s, {replay_s / len(outs):.6f} s a frame",
          file=sys.stderr, flush=True)
    mine = {k: np.stack([o[k] for o in got]).astype(np.float32)
            for k in keys}
    theirs = {k: np.stack([o[k] for o in outs]) for k in keys}
    errs = common.pose_errors(ref, mine, theirs, POS_KEYS, ROT_KEYS, parents)
    return {"pick_gap": common.worst(gaps.cpu().numpy()),
            "pos_err": common.worst([errs[k] for k in POS_KEYS]),
            "rot_err": common.worst([errs[k] for k in ROT_KEYS]),
            "ik_err": errs["ik_world_mean"]}
