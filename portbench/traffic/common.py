"""What the kinds share: the model built from a configuration with weights
from the seed, and a character's session constants worked out from its
clip, by the port or by the reference (the same calls on either)."""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .. import synth, weights
from ..seeds import numpy_seed


def generator_config(impl, config):
    return impl.generator.GeneratorConfig.from_dict(config["model"])


def cvae_config(impl, config):
    c = config["cvae"]
    return impl.cvae.CVAEConfig(
        output_seq=generator_config(impl, config).num_tokens,
        latent_dim=int(c["latent_dim"]), depth=int(c["depth"]),
        nheads=int(c["nheads"]), feedforward_dim=int(c["feedforward_dim"]),
        dropout=float(c["dropout"]))


def serving_models(impl, config, seed, dev):
    """(generator, CVAE or None) on ``dev``, frozen, with the weights of
    ``seed``, filled on the device in two draws each.  The modules are
    built on the host (their graph tables come from NumPy) and moved."""
    gen = impl.generator.Generator(generator_config(impl, config)).to(dev)
    cvae = (impl.cvae.CVAE(cvae_config(impl, config)).to(dev)
            if config.get("cvae") is not None else None)
    weights.fill_(gen, seed, "generator").requires_grad_(False).eval()
    if cvae is not None:
        weights.fill_(cvae, seed, "cvae").requires_grad_(False).eval()
    return gen, cvae


def character_clip(seed, index, rows, window, walk_speed):
    """Character ``index``'s clip: ``rows`` database windows at step 1."""
    return synth.make_mocha_bvh_data(
        T=rows + window // 4, seed=numpy_seed(seed, f"character{index}"),
        walk_speed=walk_speed)


def source_clip(seed, tag, frames, pad):
    return synth.make_mocha_bvh_data(T=frames + pad,
                                     seed=numpy_seed(seed, tag))


@torch.no_grad()
def character(impl, gen, clip, dev):
    """(norm stats, session constants, bone parents) of one character clip,
    as the port's demo mode derives them (no dataset): the clip's full
    windows for the norms, its stride-1 stream features for the database,
    the context-feature norms from those."""
    window = gen.cfg.nframes
    feats = impl.preprocess.featurize_clip(
        torch.as_tensor(clip["rotations"], dtype=torch.float32, device=dev),
        torch.as_tensor(clip["positions"], dtype=torch.float32, device=dev),
        clip["order"], clip["names"], clip["parents"])
    w = impl.windows.window_features(feats, window, 10, padded=False)
    X, Y, root = impl.dataset.window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], feats["bone_parents"])
    norm = impl.dataset.compute_norm_stats(X.cpu().numpy(), Y.cpu().numpy(),
                                           root.cpu().numpy())
    cha = impl.features.clip_stream_features_device(clip, gen, norm,
                                                    window=window, device=dev)
    cnt_norm = impl.features.compute_cnt_norm(cha["encoded"], cha["cnt"])
    consts = impl.stream.build_consts(norm, cnt_norm, None, cha, device=dev)
    return norm, consts, np.asarray(cha["bone_parents"])


def worst(values) -> float:
    """The largest of ``values``; +inf if any is not finite (a NaN never
    passes a limit)."""
    a = np.asarray(values, dtype=np.float64)
    if a.size == 0:
        return 0.0
    if not np.isfinite(a).all():
        return float("inf")
    return float(a.max())


LAUNCH_COUNTERS = ("launches", "launches_bf16", "launches_general")


def attention_launches(impl):
    """The port's attention launch counters, summed (None for an
    implementation that has none, as the reference)."""
    import importlib

    try:
        mod = importlib.import_module(f"{impl.name}.ops.attention")
    except ImportError:
        return None
    fa = getattr(mod, "fused_attention", None)
    if fa is None:
        return None
    return sum(int(getattr(fa, a, 0)) for a in LAUNCH_COUNTERS)


@contextlib.contextmanager
def stage(name, dev):
    """Log a set-up or check stage's seconds (after a device sync) on
    standard error."""
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[portbench] {name}: {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)


def world_positions(ref, rot, pos, parents) -> np.ndarray:
    """World joint positions of local rotations and positions (root row in
    world space), by the reference's forward kinematics in float64: how
    the IK's rotations place the skeleton."""
    r = torch.as_tensor(np.asarray(rot), dtype=torch.float64)
    p = torch.as_tensor(np.asarray(pos), dtype=torch.float64)
    _, g = ref.kinematics.fk(r, p, tuple(int(i) for i in parents))
    return g.numpy()


def pose_errors(ref, mine, theirs, pos_keys, rot_keys, parents):
    """{key: max |difference|} of the reference's outputs against the
    program's, over positions and rotations, and of the world positions
    the IK's rotations give: their mean (``ik_world_mean``) and, logged
    only, their max (``ik_world_max``).  The max reads float32's reach of
    ``ik_two_bone``'s arccos near a straight leg (a few tenths of a mm in
    sound runs, within 2.4x of the TF32 control), so the mean over every
    frame, stream and joint is what is compared.  Each is logged on
    standard error."""
    errs = {k: float(np.abs(np.asarray(mine[k], np.float64)
                            - np.asarray(theirs[k], np.float64)).max())
            for k in pos_keys + rot_keys}
    ik = np.abs(
        world_positions(ref, mine["ik_rot"], mine["ik_pos"], parents)
        - world_positions(ref, theirs["ik_rot"], theirs["ik_pos"], parents))
    errs["ik_world_mean"] = float(ik.mean())
    errs["ik_world_max"] = float(ik.max())
    print("[portbench] errors " + " ".join(f"{k} {v!r}" for k, v in
                                           errs.items()),
          file=sys.stderr, flush=True)
    return errs
