"""float32's reach in the IK rotations, shown on the JAX package's runner.

chip_smoke's parity phase holds the card's outputs to the CPU's; the IK
rotations (``ik_rot``) are the one output that parts, by ~1.6e-4.  This
test runs the JAX package's batch runner on the parity phase's inputs (the
full-width generator and CVAE from the port's NumPy seeds 0 and 1, a
256-window character, 2 streams x 120 frames, deterministic) twice: with
the weights as they are, and with every weight moved one float spacing
(chip_smoke.jitter_weights' rule, on the NumPy parameters before they
enter JAX).  The rotations that IK solves move by order 1e-4 while every
position and every other rotation stays under 1e-6: the reach belongs to
float32 (arccos of a near-unit dot in ``ik_two_bone``) in the JAX package
as in the port, so the card is held to it at the 1e-3 bar the CPU tests
use for rotations (tests/test_torch_stream.py).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from mocha_sigasia2023_tpu.cli.characterize import (  # noqa: E402
    build_consts as jbuild_consts)
from mocha_sigasia2023_tpu.data import dataset as jds  # noqa: E402
from mocha_sigasia2023_tpu.data import preprocess as jpre  # noqa: E402
from mocha_sigasia2023_tpu.data import windows as jwin  # noqa: E402
from mocha_sigasia2023_tpu.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import features as jfeat  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.data import dataset as pds  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models.cvae import (  # noqa: E402
    CVAEConfig, init_cvae)
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, init_generator)

STREAMS, FRAMES, DB_WINDOWS = 2, 120, 256     # chip_smoke.parity_phase
WINDOW_PAD = 15
POS_KEYS = ("src_pos", "trans_pos", "ik_pos", "cm_pos")
ROT_KEYS = ("src_rot", "trans_rot", "ik_rot", "cm_rot")
STILL = 1e-6          # what a one-spacing move leaves the other outputs
REACH = (2e-5, 1e-3)  # ik_rot: order 1e-4, inside the card's 1e-3 bar


def _jitter(tree, seed):
    """Every weight one float spacing up or down, the side drawn from
    ``seed`` (chip_smoke.jitter_weights on NumPy arrays)."""
    rng = np.random.default_rng(seed)

    def move(a):
        up = rng.random(a.shape) < 0.5
        return np.nextafter(a, np.where(up, np.inf, -np.inf).astype(a.dtype))

    return jax.tree.map(move, tree)


def _character_and_clips():
    """The weight-free inputs: the character's featurized clip and norm
    statistics, and the streams' clips."""
    cfg = jgen.GeneratorConfig()
    cha = make_mocha_bvh_data(T=DB_WINDOWS + cfg.nframes // 4, seed=10_000,
                              walk_speed=60.0)
    f0 = jpre.featurize_clip_jit(cha)
    w = jwin.window_features(f0, cfg.nframes, 10, padded=False)
    # the port's window_xy_features (held to the JAX one elsewhere) spares
    # a compile
    X, Y, root = pds.window_xy_features(
        *(torch.as_tensor(np.array(w[k])) for k in (
            "rotations", "positions", "velocities", "angular_velocities")),
        np.asarray(f0["bone_parents"]))
    norm = jds.compute_norm_stats(np.asarray(X), np.asarray(Y),
                                  np.asarray(root))
    clips = [make_mocha_bvh_data(T=FRAMES + WINDOW_PAD, seed=50 + i)
             for i in range(STREAMS)]
    return cha, norm, clips


def _run(params, cparams, inputs, runner=None):
    """The batch runner's outputs for these weights, and the runner.  A
    runner built for other weights of the same shapes is called through
    its jitted body with these, so that it compiles once."""
    cfg = jgen.GeneratorConfig()
    ccfg = jcvae.CVAEConfig(output_seq=cfg.num_tokens)
    cha, norm, clips = inputs
    cha_j = jfeat.clip_stream_features_device(cha, params, cfg, norm)
    cha_j = {k: (np.asarray(v) if k != "bone_names" else v)
             for k, v in cha_j.items()}
    consts = jbuild_consts(norm, jfeat.compute_cnt_norm(cha_j["encoded"],
                                                        cha_j["cnt"]),
                           None, cha_j)
    frame0, xs = jfeat.batch_stream_features_device(clips, params, cfg, norm,
                                                    emit_cnt=False)
    keys = jax.random.split(jax.random.PRNGKey(7), STREAMS)
    if runner is None:
        runner = jstream.make_batch_runner(params, cfg, cparams, ccfg, consts,
                                           cha_j["bone_parents"],
                                           deterministic=True)
        out = runner(frame0, xs, keys)
    else:
        out = runner._inner(params, cparams, consts, frame0, xs, keys, None)
    return jax.tree.map(np.asarray, out), runner


def test_jax_runner_shares_the_ik_rotations_float32_reach():
    cfg = GeneratorConfig()
    params = convert.pytree_from_state_dict(
        init_generator(cfg, seed=0, device="cpu").state_dict())
    cparams = convert.pytree_from_state_dict(
        init_cvae(CVAEConfig(output_seq=cfg.num_tokens), seed=1,
                  device="cpu").state_dict())
    inputs = _character_and_clips()
    a, runner = _run(params, cparams, inputs)
    b, _ = _run(_jitter(params, 4100), _jitter(cparams, 4101), inputs,
                runner)
    np.testing.assert_array_equal(a["nn_index"], b["nn_index"])
    moves = {k: float(np.abs(a[k] - b[k]).max()) for k in POS_KEYS + ROT_KEYS}
    print(f"one-spacing jitter, JAX runner: {moves}")
    assert REACH[0] < moves["ik_rot"] < REACH[1], moves
    others = {k: v for k, v in moves.items() if k != "ik_rot"}
    assert max(others.values()) < STILL, others
    assert moves["ik_rot"] > 100 * max(others.values()), moves
