"""Generator training: ``train/trainer.GeneratorTrainer.train_step`` as
``cli/train`` drives it (batch from the mix, the configuration's training
settings, TF32 off), its batches through ``cli/train.device_batches``
(``data/dataset.prefetch_batches`` from pinned memory) over a dataset of
windows made in memory in set-up from seeded synthetic clips, as
``cli/generate_database`` and ``data/dataset.MotionDataset`` make them
(both mirror variants, contacts at 0.2 m/s, windows of the model's frames
every 20).  Epochs turn as ``cli/train``'s loop turns them, inside the
window where it runs that far.

Set-up builds the trainer, fills its weights from the seed and drives it
through its first ``check_steps`` steps through the window's own call and
feed, keeping what the check reads: each step's loss, the first step's
gradient as AdamW takes it, and each leaf's change and the EMA's over
those steps.  The window then continues the same trainer.  After the
window its state goes to the host, and ``check_steps`` more steps through
the same call and feed are kept alike (the moves over the first of them):
the check's late stage, which the reference follows from that state.

Mix parameters: ``batch``, ``clips``, ``clip_frames``, ``window_step``,
``check_steps``, ``profile_steps``.
"""

from __future__ import annotations

import importlib
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, synth, weights
from ..seeds import numpy_seed
from ..harness import PROGRAM
from ..trace import Spans, Trace, profile_slice, sync
from . import common

END_TO_END = {"train_samples_per_s": "samples/s"}
ADAM_BETA1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under AdamW and is not compared
ROUNDING_LEAF = 1e-3


def trainer_config(config, mix) -> Dict:
    keys = ("model", "dataset", "lr_gen", "weight_decay_gen", "lr_drop",
            "grad_clip", "ema_beta", "rec_w", "nce_w", "cyc_w")
    out = {k: config[k] for k in keys}
    out["batch_size"] = int(mix["batch"])
    return out


def train_clips(mix, seed):
    return [synth.make_mocha_bvh_data(
        T=int(mix["clip_frames"]), seed=numpy_seed(seed, f"train clip{i}"),
        walk_speed=40.0 + 4.0 * (i % 16))
        for i in range(int(mix["clips"]))]


class Windows:
    """The training windows in host memory, as ``MotionDataset`` serves
    them to ``iterate_batches``."""

    def __init__(self, X, Y):
        self.X, self.Y = X.astype(np.float32), Y.astype(np.float32)

    def __len__(self):
        return len(self.X)

    def __getitem__(self, index):
        return {"X": self.X[index], "Y": self.Y[index]}


@torch.no_grad()
def dataset(impl, mix, seed, dev):
    """(windows, norm) from the mix's clips: each clip featurized original
    and mirrored, in ``cli/generate_database``'s order, then windowed and
    made into X / Y features as ``MotionDataset`` makes them."""
    clips = train_clips(mix, seed)
    c0 = clips[0]
    rot = torch.as_tensor(np.stack([c["rotations"] for c in clips]),
                          dtype=torch.float32, device=dev)
    pos = torch.as_tensor(np.stack([c["positions"] for c in clips]),
                          dtype=torch.float32, device=dev)
    variants = [impl.preprocess.featurize_clip(
        rot, pos, c0["order"], c0["names"], c0["parents"], mirror=m,
        contact_velocity_threshold=0.2, fps=60.0) for m in (False, True)]
    N, T = rot.shape[:2]

    def packed(key):   # clip-major, original then mirrored
        a = torch.stack([v[key] for v in variants], dim=1)
        return a.reshape((2 * N * T,) + a.shape[3:]).cpu().numpy()

    db = {"bone_positions": packed("positions"),
          "bone_velocities": packed("velocities"),
          "bone_rotations": packed("rotations"),
          "bone_angular_velocities": packed("angular_velocities"),
          "bone_parents": np.asarray(variants[0]["bone_parents"], np.int32),
          "range_starts": np.arange(2 * N, dtype=np.int32) * T,
          "range_stops": np.arange(1, 2 * N + 1, dtype=np.int32) * T,
          "style_labels": np.zeros(2 * N, np.int32),
          "action_labels": np.zeros(2 * N, np.int32)}
    idx, _, _ = impl.dataset.database_window_features(
        db, window=60, step=int(mix["window_step"]))
    X, Y, root = impl.dataset.compute_window_features(
        db["bone_rotations"][idx], db["bone_positions"][idx],
        db["bone_velocities"][idx], db["bone_angular_velocities"][idx],
        db["bone_parents"], device=dev)
    return Windows(X, Y), impl.dataset.compute_norm_stats(X, Y, root)


def initial_weights(impl, config, seed, dev):
    """{"gen", "prj"} state dicts of the seed's initial weights."""
    gcfg = impl.generator.GeneratorConfig.from_dict(config["model"])
    prj_mod = importlib.import_module(f"{impl.name}.models.projector")
    m = config["model"]
    pcfg = prj_mod.ProjectorConfig(
        mode="all", num_patches=m.get("num_patches", -1),
        encoder_dim=gcfg.encoder_dim, prj_dim=m.get("prj_dim", 1024),
        nframes=gcfg.nframes, temporal_patch_size=gcfg.temporal_patch_size)
    gen = impl.generator.Generator(gcfg).to(dev)
    prj = prj_mod.Projector(pcfg).to(dev)
    weights.fill_(gen, seed, "train generator")
    weights.fill_(prj, seed, "train projector")
    return {"gen": gen.state_dict(), "prj": prj.state_dict()}


def batch_stream(impl, ds, mix, seed, place):
    """(src batch, cha batch) pairs over epochs, shuffled as ``cli/train``
    shuffles them (the order's seed from the run's seed)."""
    order_seed = numpy_seed(seed, "train order") % (2 ** 31)
    B = int(mix["batch"])
    for epoch in itertools.count():
        src = place(impl.dataset.iterate_batches(
            ds, B, shuffle=True, seed=order_seed, epoch=epoch))
        cha = place(impl.dataset.iterate_batches(
            ds, B, shuffle=True, seed=order_seed + 10_000, epoch=epoch))
        yield from zip(src, cha)


def dropout_keys(impl, seed):
    """The per-step dropout generators, split as ``cli/train`` splits its
    key."""
    key = torch.Generator().manual_seed(numpy_seed(seed, "train key"))
    while True:
        key, sub = impl.layers.split(key, 2)
        yield sub


def leaf_norms(tensors) -> np.ndarray:
    return torch.stack([t.detach().double().norm() for t in tensors]
                       ).cpu().numpy()


class Session:
    def __init__(self, impl, cell, seed, dev):
        mix, config = cell.mix, cell.config
        self.dev, self.mix = dev, mix
        train_cli = importlib.import_module(f"{impl.name}.cli.train")
        trainer_mod = impl.trainer
        with common.stage("set-up: dataset", dev):
            ds, norm = dataset(impl, mix, seed, dev)
        self.norm = {k: torch.as_tensor(v, device=dev)
                     for k, v in norm.items()}
        steps_per_epoch = max(len(ds) // int(mix["batch"]), 1)
        with common.stage("set-up: trainer", dev):
            self.trainer = trainer_mod.GeneratorTrainer(
                trainer_config(config, mix), steps_per_epoch,
                seed=numpy_seed(seed, "trainer"), device=dev)
        with common.stage("set-up: weights", dev):
            w = initial_weights(impl, config, seed, dev)
        with torch.no_grad():
            self.trainer.gen.load_state_dict(w["gen"])
            self.trainer.prj.load_state_dict(w["prj"])
            self.trainer.gen_ema.load_state_dict(w["gen"])
        self.feed = batch_stream(
            impl, ds, mix, seed,
            lambda b: train_cli.device_batches(b, dev))
        self.keys = dropout_keys(impl, seed)
        self.losses: List[torch.Tensor] = []

    def params(self):
        return [*self.trainer.gen.parameters(), *self.trainer.prj.parameters()]

    def step(self) -> None:
        bs, bc = next(self.feed)
        metrics = self.trainer.train_step(bs, bc, self.norm, next(self.keys))
        self.losses.append(metrics["gen/loss_total"])


def exp_avgs(session_like) -> List[torch.Tensor]:
    """AdamW's first moment of each parameter, copied (zeros before a
    parameter has one)."""
    opt = session_like.trainer.opt
    return [opt.state[p]["exp_avg"].detach().clone()
            if "exp_avg" in opt.state[p] else torch.zeros_like(p)
            for p in session_like.params()]


def follow(session_like, n, moved=None):
    """Drive ``n`` steps from where the trainer stands, keeping each loss,
    the first step's gradient norms as AdamW takes them ((exp_avg after -
    beta1 * exp_avg before) / (1 - beta1)) and each leaf's change and the
    EMA's change over the first ``moved`` steps (all ``n`` by default)."""
    trainer = session_like.trainer
    moved = n if moved is None else moved
    p0 = [p.detach().clone() for p in session_like.params()]
    e0 = [p.detach().clone() for p in trainer.gen_ema.parameters()]
    m0 = exp_avgs(session_like)
    start = len(session_like.losses)
    out = {}
    for i in range(n + 1):
        if i == moved:
            out["change"] = leaf_norms(
                [p - q for p, q in zip(session_like.params(), p0)])
            out["ema"] = leaf_norms(
                [p - q for p, q in zip(trainer.gen_ema.parameters(), e0)])
        if i == n:
            break
        session_like.step()
        if i == 0:
            out["grad"] = leaf_norms(
                [(m - ADAM_BETA1 * m_) / (1.0 - ADAM_BETA1)
                 for m, m_ in zip(exp_avgs(session_like), m0)])
    out["losses"] = torch.stack(session_like.losses[start:start + n]
                                ).double().cpu().numpy()
    out["names"] = ([f"gen.{k}" for k, _ in trainer.gen.named_parameters()]
                    + [f"prj.{k}" for k, _ in
                       trainer.prj.named_parameters()])
    return out


def snapshot(session_like) -> Dict:
    """The trainer's state on the host, where the window left it: the
    weights, the EMA, AdamW's moments and learning rates, the schedule,
    and how many batches and dropout keys the run has taken."""
    trainer = session_like.trainer

    def host(module):
        return {k: v.detach().cpu().clone()
                for k, v in module.state_dict().items()}

    opt = trainer.opt

    def moments(p):   # AdamW's own start where a leaf has no state yet
        st = opt.state[p]
        if "exp_avg" not in st:
            return {"step": 0.0, "exp_avg": torch.zeros_like(p).cpu(),
                    "exp_avg_sq": torch.zeros_like(p).cpu()}
        return {"step": float(st["step"]),
                "exp_avg": st["exp_avg"].detach().cpu().clone(),
                "exp_avg_sq": st["exp_avg_sq"].detach().cpu().clone()}

    return {"gen": host(trainer.gen), "prj": host(trainer.prj),
            "gen_ema": host(trainer.gen_ema),
            "moments": [moments(p) for p in session_like.params()],
            "lr": [g["lr"] for g in opt.param_groups],
            "schedule": trainer.schedule.state_dict(), "step": trainer.step,
            "taken": len(session_like.losses)}


def setup(cell, seed, dev, impl):
    # the control puts the reference's trainer in the program's place
    session = (Session(impl, cell, seed, dev) if impl.name == PROGRAM
               else Reference(cell, seed, dev))
    with common.stage("set-up: first steps", dev):
        session.first = follow(session, int(cell.mix["check_steps"]))
    sync(dev)
    return session


def window(cell, session: Session, seconds: float, traced: bool):
    mix, dev = cell.mix, session.dev
    start = len(session.losses)
    spans = Spans(dev)
    slice_ = None
    if traced:
        n = int(mix["profile_steps"])

        def steps():
            for _ in range(n):
                session.step()

        _, slice_ = profile_slice(steps, dev, steps=n)
    before = len(session.losses)

    def loop():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            session.step()

    t0 = time.perf_counter()
    spans.timed("steps", loop)
    elapsed = time.perf_counter() - t0
    steps = len(session.losses) - before
    losses = torch.stack(session.losses[start:]).cpu().numpy()
    failed = int((~np.isfinite(losses)).sum())
    e2e = {"train_samples_per_s": steps * int(mix["batch"]) / elapsed}
    # the check's late stage: the state the window left, then
    # ``check_steps`` more steps through the same call and feed.  Moves are
    # taken over the first of them: from a trained state, rounding apart
    # (atomics in the backward) grows over the next two steps until the
    # worst leaf's change reads as far apart as the TF32 control's
    late_state = snapshot(session)
    late = follow(session, int(mix["check_steps"]), moved=1)
    trace = None
    if traced:
        trace = Trace(kind="train", mix=mix, slice=slice_, spans=spans,
                      facts={"step_flops": flops.train_step_flops(
                                 cell.config, int(mix["batch"])),
                             "window_steps": steps})
    return {"attempted": len(losses), "failed": failed, "e2e": e2e,
            "trace": trace, "first": session.first, "late": late,
            "late_state": late_state}


def release(session) -> None:
    session.trainer = session.feed = None
    session.losses = []


class Reference:
    """The plain reference's trainer, fed as the program's was."""

    def __init__(self, cell, seed, dev):
        from ..harness import implementation

        ref = implementation("portbench.reference")
        mix, config = cell.mix, cell.config
        self.dev, self.mix = dev, mix
        ds, norm = dataset(ref, mix, seed, dev)
        self.norm = {k: torch.as_tensor(v, device=dev)
                     for k, v in norm.items()}
        w = initial_weights(ref, config, seed, dev)
        self.trainer = ref.trainer.GeneratorTrainer(
            trainer_config(config, mix), max(len(ds) // int(mix["batch"]), 1),
            w, device=dev)

        def place(batches):
            for b in batches:
                yield {k: torch.as_tensor(b[k], device=dev)
                       for k in ("X", "Y")}

        self.feed = batch_stream(ref, ds, mix, seed, place)
        self.keys = dropout_keys(ref, seed)
        self.losses: List[torch.Tensor] = []

    params = Session.params
    step = Session.step

    @torch.no_grad()
    def resume(self, state) -> None:
        """Take up the program's state where its window left it (weights,
        EMA, AdamW, schedule), and pass over the batches and dropout keys
        the program took, so that the next step gets the same as the
        program's did."""
        t = self.trainer
        t.gen.load_state_dict(state["gen"])
        t.prj.load_state_dict(state["prj"])
        t.gen_ema.load_state_dict(state["gen_ema"])
        for p, m in zip(self.params(), state["moments"]):
            t.opt.state[p] = {"step": torch.tensor(m["step"]),
                              "exp_avg": m["exp_avg"].to(self.dev),
                              "exp_avg_sq": m["exp_avg_sq"].to(self.dev)}
        for group, lr in zip(t.opt.param_groups, state["lr"]):
            group["lr"] = lr
        t.schedule.load_state_dict(state["schedule"])
        t.step = state["step"]
        for _ in range(state["taken"] - len(self.losses)):
            next(self.feed)
            next(self.keys)


def gap(mine, theirs, counted):
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    scale = np.maximum(theirs, np.median(theirs[counted]))
    g = np.abs(mine - theirs) / scale
    return float(np.max(np.where(counted, g, 0.0))) \
        if np.isfinite(g[counted]).all() else float("inf")


def gaps(mine, ref, prefix="") -> Dict[str, float]:
    """Each step's loss, the first step's gradient, each leaf's change and
    the EMA's, the program's against the reference's."""
    if ref["names"] != mine["names"]:
        raise ValueError("the reference's parameters differ from the "
                         "program's")
    counted = ref["grad"] >= ROUNDING_LEAF * np.median(ref["grad"])
    n_gen = len(ref["ema"])
    loss_gap = np.abs(mine["losses"] - ref["losses"]) / np.abs(ref["losses"])
    return {f"{prefix}loss_gap": float(loss_gap.max())
            if np.isfinite(loss_gap).all() else float("inf"),
            f"{prefix}grad_gap": gap(mine["grad"], ref["grad"], counted),
            f"{prefix}change_gap": gap(mine["change"], ref["change"],
                                       counted),
            f"{prefix}ema_gap": gap(mine["ema"], ref["ema"],
                                    counted[:n_gen])}


def check(cell, seed, dev, record, limits) -> Dict[str, float]:
    """The reference follows the first ``check_steps`` steps from the same
    weights, batches and dropout keys; then, from the program's state
    where the window left it, the ``check_steps`` steps the program took
    after the window, on the same batches and keys (``late_``).  Each
    stage compares each step's loss, the first gradient's norm a leaf, and
    each leaf's change and the EMA's, by the worst leaf: over the stage's
    steps at the start, over its first step in the late stage."""
    n = int(cell.mix["check_steps"])
    with common.stage("check: reference steps", dev):
        ref = Reference(cell, seed, dev)
        first = follow(ref, n)
        ref.resume(record["late_state"])
        late = follow(ref, n, moved=1)
    return {**gaps(record["first"], first),
            **gaps(record["late"], late, "late_")}
