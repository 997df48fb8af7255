"""Offline characterization: a closed loop of whole batches.

Each batch is ``streams`` synthetic clips of ``frames`` output frames (plus
the window's pad), drawn from a pool made in set-up, served against one
character or round-robin over a stack of characters.  The entry the window
drives is the port's shipped offline path as ``cli/characterize --src-dir
--production`` builds it: ``runtime/features.batch_stream_features_device``
(featurize + encode), then the runner of ``runtime/stream.
make_batch_runner`` (match, CVAE sample, decode, root integration,
foot-contact IK; ``compute_cm=False``, float64 roots, float32 elsewhere),
and the poses copied to the host.  A batch ends when its poses are there.

Mix parameters: ``streams``, ``frames``, ``pad`` (frames the window eats),
``pool`` (clips made in set-up), ``characters``, ``database_windows``
(character c has ``database_windows - window_step * c``), ``walk_speed``
and ``walk_speed_step`` (character c walks at ``walk_speed +
walk_speed_step * c`` cm/s).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .. import flops
from ..seeds import numpy_seed, subseed
from ..trace import Spans, Trace, profile_slice
from . import common

END_TO_END = {"frames_per_s": "frames/s"}
POS_KEYS = ("src_pos", "trans_pos", "ik_pos")
# the IK's rotations are compared through the world positions they give:
# alone they read float32's reach of ik_two_bone's arccos (about 2e-4) in
# sound runs and in the control alike
ROT_KEYS = ("src_rot", "trans_rot")
CHUNK = 128   # the port's featurize chunk (windows an encoder call)
CHECK_CHARACTERS = 8


@dataclass
class Batch:
    clips: List[int]                 # pool indices, stream order
    noise_seed: int
    out: Dict[str, np.ndarray] = field(default_factory=dict)


def characters_of(mix):
    n = int(mix["characters"])
    return [(int(mix["database_windows"]) - int(mix["window_step"]) * c,
             float(mix["walk_speed"]) + float(mix["walk_speed_step"]) * c)
            for c in range(n)]


def char_ids(mix):
    """Stream s is served character s % characters."""
    return np.arange(int(mix["streams"])) % int(mix["characters"])


def build_characters(impl, gen, mix, seed, dev, only=None):
    """(norm of character 0, constants (one character's, or the stack),
    parents); ``only`` keeps those characters, in that order.  Every
    source clip is featurized with character 0's norms."""
    window = gen.cfg.nframes
    per_char, norm0, parents = [], None, None
    kept = range(int(mix["characters"])) if only is None else only
    if only is not None and only[0] != 0:
        rows0, walk0 = characters_of(mix)[0]
        clip = common.character_clip(seed, 0, rows0, window, walk0)
        norm0 = common.character(impl, gen, clip, dev)[0]
    for c in kept:
        rows, walk = characters_of(mix)[c]
        clip = common.character_clip(seed, c, rows, window, walk)
        norm, consts, parents = common.character(impl, gen, clip, dev)
        norm0 = norm if norm0 is None else norm0
        per_char.append(consts)
    if int(mix["characters"]) == 1:
        return norm0, per_char[0], parents
    return norm0, impl.stream.stack_consts(per_char), parents


def pool_clips(mix, seed):
    return [common.source_clip(seed, f"clip{i}", int(mix["frames"]),
                               int(mix["pad"]))
            for i in range(int(mix["pool"]))]


class Session:
    """The program's objects for one cell, and the entry the window
    drives."""

    def __init__(self, impl, cell, seed, dev):
        mix = cell.mix
        self.impl, self.mix, self.dev, self.seed = impl, mix, dev, seed
        with common.stage("set-up: models", dev):
            self.gen, self.cvae = common.serving_models(impl, cell.config,
                                                        seed, dev)
        with common.stage("set-up: characters", dev):
            self.norm, consts, parents = build_characters(
                impl, self.gen, mix, seed, dev)
        self.multi = int(mix["characters"]) > 1
        self.char_ids = char_ids(mix) if self.multi else None
        with common.stage("set-up: clip pool", dev):
            self.pool = pool_clips(mix, seed)
        self.runner = impl.stream.make_batch_runner(
            self.gen, self.cvae, consts, parents, compute_cm=False,
            root_dtype=torch.float64, multi_character=self.multi,
            device=dev)
        self.draw = np.random.RandomState(numpy_seed(seed, "batches"))
        self.batches_drawn = 0

    def next_batch(self) -> Batch:
        ids = self.draw.permutation(len(self.pool))[:int(self.mix["streams"])]
        b = self.batches_drawn
        self.batches_drawn += 1
        return Batch(clips=[int(i) for i in ids],
                     noise_seed=subseed(self.seed, f"noise{b}"))

    def featurize(self, batch: Batch):
        return self.impl.features.batch_stream_features_device(
            [self.pool[i] for i in batch.clips], self.gen, self.norm,
            window=self.gen.cfg.nframes, emit_cnt=False, device=self.dev)

    def characterize(self, batch: Batch, inputs):
        frame0, xs = inputs
        generator = torch.Generator(device=self.dev).manual_seed(
            batch.noise_seed)
        out = self.runner(frame0, xs, generator, char_ids=self.char_ids)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def serve(self, batch: Batch):
        batch.out = self.characterize(batch, self.featurize(batch))
        return batch


def setup(cell, seed, dev, impl):
    session = Session(impl, cell, seed, dev)
    with common.stage("set-up: warm-up batch", dev):
        session.serve(session.next_batch())   # every shape; the allocator
                                              # grown to a batch
    return session


def window(cell, session: Session, seconds: float, traced: bool):
    mix, dev = cell.mix, session.dev
    frames = int(mix["streams"]) * int(mix["frames"])
    batches: List[Batch] = []
    spans = Spans(dev)
    slice_, counters = None, {}
    if traced:      # the first batch profiled, the rest in synced spans
        before = common.attention_launches(session.impl)
        batch, slice_ = profile_slice(
            lambda: session.serve(session.next_batch()), dev,
            steps=int(mix["frames"]), frames=frames)
        if before is not None:
            counters["attention_launches"] = (
                common.attention_launches(session.impl) - before)
        batches.append(batch)
    t0 = time.perf_counter()
    while True:
        batch = session.next_batch()
        if traced:
            def one():
                inputs = spans.timed(
                    "featurize", lambda: session.featurize(batch))
                batch.out = spans.timed(
                    "runner", lambda: session.characterize(batch, inputs))
            spans.timed("batch", one)
        else:
            session.serve(batch)
        batches.append(batch)
        done = len(batches) - (1 if traced else 0)
        if time.perf_counter() - t0 >= seconds and (done >= 2 or not traced):
            break
    elapsed = time.perf_counter() - t0
    served = len(batches) - (1 if traced else 0)
    failed = sum(1 for b in batches
                 if not all(np.isfinite(b.out[k]).all()
                            for k in POS_KEYS + ROT_KEYS + ("ik_rot",)))
    e2e = {"frames_per_s": served * frames / elapsed}
    trace = None
    if traced:
        rows = [r for r, _ in characters_of(mix)]
        rows_per_stream = ([rows[c] for c in char_ids(mix)]
                           if len(rows) > 1 else rows * int(mix["streams"]))
        trace = Trace(
            kind="offline", mix=mix,
            slice=slice_, spans=spans, counters=counters,
            facts={"batch_flops": flops.offline_batch_flops(
                       cell.config, int(mix["streams"]), int(mix["frames"]),
                       rows_per_stream, CHUNK),
                   "attention_calls": attention_calls(cell.config, mix)})
    return {"attempted": len(batches), "failed": failed, "e2e": e2e,
            "trace": trace, "batches": batches}


def attention_calls(config, mix):
    """[(B, H, N, M, d, dtype, calls)] of one batch's attention products:
    the encoder's over every window in CHUNK-window calls, then the
    decoder's, one decode a frame for every stream."""
    m = config["model"]
    tokens = (int(m["nframes"]) // int(m["temporal_patch_size"])
              * int(m["nbody"]))
    S, T = int(mix["streams"]), int(mix["frames"])
    full, rest = divmod(S * T, CHUNK)
    out = [(CHUNK, int(m["encoder_heads"]), tokens, tokens,
            int(m["encoder_dim_head"]), "float32",
            full * int(m["encoder_depth"]))]
    if rest:
        out.append((rest, int(m["encoder_heads"]), tokens, tokens,
                    int(m["encoder_dim_head"]), "float32",
                    int(m["encoder_depth"])))
    out.append((S, int(m["decoder_heads"]), tokens, tokens,
                int(m["decoder_dim_head"]), "float32",
                T * int(m["decoder_depth"])))
    return out


def release(session: Session) -> None:
    session.runner = session.gen = session.cvae = None


@torch.no_grad()
def check(cell, seed, dev, record, limits) -> Dict[str, float]:
    """One batch of the window, drawn from the seed, worked out again by
    the plain reference from the same clips and weights: the program's
    picks judged by their distance gap, then the reference run on those
    picks, every pose and rotation compared (the IK's rotations through
    the world positions they give).  Over a stack of more than
    ``CHECK_CHARACTERS`` characters, the streams of that many characters
    drawn from the seed are compared (the generator's streams draw no
    noise, so a stream's answer does not depend on the others')."""
    from ..harness import implementation

    ref = implementation("portbench.reference")
    mix = cell.mix
    batches = record["batches"]
    rng = np.random.RandomState(numpy_seed(seed, "check"))
    batch = batches[rng.randint(len(batches))]
    n_chars = int(mix["characters"])
    streams = np.arange(int(mix["streams"]))
    chars = list(range(n_chars))
    if n_chars > CHECK_CHARACTERS and cell.config.get("cvae") is None:
        chars = sorted(rng.choice(n_chars, CHECK_CHARACTERS, replace=False))
        streams = streams[np.isin(char_ids(mix), chars)]
    with common.stage("check: reference characters", dev):
        gen, cvae = common.serving_models(ref, cell.config, seed, dev)
        norm, consts, parents = build_characters(ref, gen, mix, seed, dev,
                                                 only=chars)
    multi = n_chars > 1
    # each compared stream's character within the reference's stack
    local = np.searchsorted(chars, char_ids(mix)[streams]) if multi \
        else np.zeros(len(streams), int)
    pool = pool_clips(mix, seed)
    with common.stage("check: reference batch", dev):
        frame0, xs = ref.features.batch_stream_features_device(
            [pool[batch.clips[i]] for i in streams], gen, norm,
            window=gen.cfg.nframes, emit_cnt=False, device=dev)
        picks = torch.as_tensor(batch.out["nn_index"][:, streams],
                                device=dev)
        gaps = match_gaps(ref, consts, frame0, xs, local, picks, multi, dev)
        # the reference steps on the program's picks, kept inside each
        # stream's database (a pick outside it has already failed)
        rows = consts.cha_cnt_sq.shape[-1]
        picks = picks.clamp(0, rows - 1)
        runner = ref.stream.make_batch_runner(
            gen, cvae, consts, parents, compute_cm=False,
            root_dtype=torch.float64, multi_character=multi, device=dev)
        generator = torch.Generator(device=dev).manual_seed(batch.noise_seed)
        out = runner(frame0, xs, generator,
                     char_ids=local if multi else None, picks=picks)
        out = {k: v.cpu().numpy() for k, v in out.items()}
    theirs = {k: v[:, streams] for k, v in batch.out.items()}
    errs = common.pose_errors(ref, out, theirs, POS_KEYS, ROT_KEYS, parents)
    return {"pick_gap": gaps,
            "pos_err": common.worst([errs[k] for k in POS_KEYS]),
            "rot_err": common.worst([errs[k] for k in ROT_KEYS]),
            "ik_err": errs["ik_world_mean"]}


def match_gaps(ref, consts, frame0, xs, cids, picks, multi, dev):
    """The widest gap by which a program pick's squared distance lies above
    the nearest row's, as a share of the nearest, over every (frame,
    stream) compared; queries and database as the reference makes
    them."""
    enc = torch.cat([frame0["encoded"][None], xs["encoded"]])   # (T, S, ..)
    cid = torch.as_tensor(cids, device=dev)
    if multi:
        mean, std = consts.cnt_mean[cid], consts.cnt_std[cid]
        db, sq = consts.cha_cnt_flat, consts.cha_cnt_sq
    else:
        mean, std = consts.cnt_mean[None], consts.cnt_std[None]
        db, sq = consts.cha_cnt_flat[None], consts.cha_cnt_sq[None]
    worst = 0.0
    for s in range(0, enc.shape[0], 32):
        cnt = ref.generator.content_feature(enc[s:s + 32])
        q = ((cnt - mean) / std).flatten(-2)
        gap = ref.matching.pick_gaps(q, db, sq, cid, picks[s:s + 32])
        worst = max(worst, common.worst(gap.cpu().numpy()))
    return worst
