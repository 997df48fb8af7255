"""The port's batched stream runner and the whole serving slice vs JAX.

Deterministic mode (the CVAE takes z = mu), 2 streams of 100 frames, small
widths.  (a) The port's runner is fed the JAX package's stream features,
so the step is held alone against ``make_batch_runner``; (b) the whole
slice runs from raw clip arrays through the port.  Positions are held to
1e-3 (PARITY.md:87) and nearest-neighbour picks must be identical.  The
JAX side runs with float32 root carries (float64 would switch on
jax_enable_x64 for the whole worker process); the port also runs float64.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.cli.characterize import (  # noqa: E402
    build_consts as jbuild_consts)
from mocha_sigasia2023_tpu.data import dataset as jds  # noqa: E402
from mocha_sigasia2023_tpu.data import preprocess as jpre  # noqa: E402
from mocha_sigasia2023_tpu.data import windows as jwin  # noqa: E402
from mocha_sigasia2023_tpu.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import features as jfeat  # noqa: E402
from mocha_sigasia2023_tpu.runtime import matching as jmatch  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as tfeat  # noqa: E402
from mocha_sigasia2023_torch.runtime import matching as tmatch  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream as tstream  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
CVAE_SMALL = dict(latent_dim=32, depth=1, nheads=2, feedforward_dim=64)
POS_TOL = 1e-3
POS_KEYS = ("src_pos", "trans_pos", "ik_pos", "cm_pos")
ROT_KEYS = ("src_rot", "trans_rot", "ik_rot", "cm_rot")


def _np(tree):
    return jax.tree.map(np.array, tree)   # writable copies for torch


@pytest.fixture(scope="module")
def pipe():
    jcfg = jgen.GeneratorConfig(**SMALL)
    params = jgen.init_generator(jax.random.PRNGKey(11), jcfg)
    jccfg = jcvae.CVAEConfig(**CVAE_SMALL)
    cparams = jcvae.init_cvae(jax.random.PRNGKey(12), jccfg)
    tg = convert.generator_from_jax(_np(params), tgen.GeneratorConfig(**SMALL),
                                    device="cpu")
    tc = convert.cvae_from_jax(_np(cparams), tcvae.CVAEConfig(**CVAE_SMALL),
                               device="cpu")

    cha = make_mocha_bvh_data(T=140, seed=10_000, walk_speed=60.0)
    f0 = jpre.featurize_clip_jit(cha)
    w = jwin.window_features(f0, 60, 10, padded=False)
    X, Y, root = jds.window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], f0["bone_parents"])
    norm = jds.compute_norm_stats(np.asarray(X), np.asarray(Y),
                                  np.asarray(root))
    cha_j = jfeat.clip_stream_features_device(cha, params, jcfg, norm)
    cha_j = {k: (np.asarray(v) if k != "bone_names" else v)
             for k, v in cha_j.items()}
    cnt_norm_j = jfeat.compute_cnt_norm(cha_j["encoded"], cha_j["cnt"])
    consts_j = jbuild_consts(norm, cnt_norm_j, None, cha_j)

    clips = [make_mocha_bvh_data(T=115, seed=20 + i) for i in range(2)]
    frame0_j, xs_j = jfeat.batch_stream_features_device(
        clips, params, jcfg, norm)
    runner_j = jstream.make_batch_runner(
        params, jcfg, cparams, jccfg, consts_j, cha_j["bone_parents"],
        deterministic=True)
    out_j = _np(runner_j(frame0_j, xs_j,
                         jax.random.split(jax.random.PRNGKey(7), 2)))
    return dict(jcfg=jcfg, params=params, tg=tg, tc=tc, cha=cha, norm=norm,
                cha_j=cha_j, cnt_norm_j=cnt_norm_j, consts_j=consts_j, clips=clips,
                frame0_j=_np(frame0_j), xs_j=_np(xs_j), out_j=out_j)


def _nn_gaps(consts, encoded, idx_a, idx_b):
    """Distance gap between two database picks for each query frame."""
    cnt = tgen.content_feature(encoded)
    q = ((cnt - consts.cnt_mean) / consts.cnt_std).reshape(len(cnt), -1)
    d2 = consts.cha_cnt_sq - 2.0 * q @ consts.cha_cnt_flat.T
    rows = torch.arange(len(cnt))
    return (d2[rows, idx_a] - d2[rows, idx_b]).tolist()


def _check_against_jax(out_t, out_j, consts, encoded_all):
    assert set(out_t) == set(out_j)
    picks_t = out_t["nn_index"].numpy()
    picks_j = out_j["nn_index"]
    if not np.array_equal(picks_t, picks_j):
        bad = np.argwhere(picks_t != picks_j)
        enc = torch.stack([encoded_all[f, s] for f, s in bad])
        gaps = _nn_gaps(consts, enc, torch.as_tensor(picks_t[tuple(bad.T)]),
                        torch.as_tensor(picks_j[tuple(bad.T)]))
        pytest.fail(f"NN picks differ at (frame, stream) {bad.tolist()}; "
                    f"distance gaps port-pick minus JAX-pick: {gaps}")
    for k in POS_KEYS:
        assert out_t[k].shape == out_j[k].shape, k
        err = np.abs(out_t[k].numpy() - out_j[k]).max()
        assert err <= POS_TOL, (k, err)
    for k in ROT_KEYS:
        err = np.abs(out_t[k].numpy() - out_j[k]).max()
        assert err <= POS_TOL, (k, err)
    np.testing.assert_array_equal(out_t["contact"].numpy(), out_j["contact"])


def _encoded_all(frame0, xs):
    return torch.cat([torch.as_tensor(frame0["encoded"])[None],
                      torch.as_tensor(xs["encoded"])])


def test_build_consts_matches_jax(pipe):
    consts_t = tstream.build_consts(pipe["norm"], pipe["cnt_norm_j"], None,
                                    pipe["cha_j"], device="cpu")
    for name, a in consts_t._asdict().items():
        b = np.asarray(getattr(pipe["consts_j"], name))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-5,
                                   err_msg=name)


def test_stack_stream_inputs_matches_jax(pipe):
    feats = {k: np.stack([pipe["cha_j"][k]] * 2) for k in
             tstream.FEAT_KEYS + ("cnt",)}
    f0_t, xs_t = tstream.stack_stream_inputs(feats, device="cpu")
    f0_j, xs_j = jstream.stack_stream_inputs(feats, device=False)
    for k in f0_j:
        np.testing.assert_array_equal(f0_t[k].numpy(), f0_j[k])
        np.testing.assert_array_equal(xs_t[k].numpy(), xs_j[k])


def test_nn_index_matches_jax():
    rng = np.random.RandomState(0)
    db = rng.randn(300, 64).astype(np.float32)
    q = rng.randn(7, 5, 64).astype(np.float32)
    q[0, 0] = db[17]
    sq = (db * db).sum(-1)
    got = tmatch.nn_index(torch.as_tensor(q), torch.as_tensor(db),
                          torch.as_tensor(sq)).numpy()
    want = np.asarray(jmatch.nn_index(jnp.asarray(q), jnp.asarray(db),
                                      jnp.asarray(sq)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 17
    np.testing.assert_array_equal(
        tmatch.nn_index(torch.as_tensor(q), torch.as_tensor(db)).numpy(),
        want)


def test_runner_on_jax_features_matches_jax(pipe):
    """(a) The port's step alone: JAX stream features in, f32 carries."""
    consts = tstream.build_consts(pipe["norm"], pipe["cnt_norm_j"], None,
                                  pipe["cha_j"], device="cpu")
    runner = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], consts, pipe["cha_j"]["bone_parents"],
        deterministic=True, device="cpu")
    f0 = {k: torch.as_tensor(v) for k, v in pipe["frame0_j"].items()}
    xs = {k: torch.as_tensor(v) for k, v in pipe["xs_j"].items()}
    out_t = runner(f0, xs)
    assert out_t["src_pos"].shape == (100, 2, 25, 3)
    _check_against_jax(out_t, pipe["out_j"], consts, _encoded_all(f0, xs))


@pytest.mark.parametrize("root_dtype", [torch.float32, torch.float64])
def test_whole_slice_from_raw_clips_matches_jax(pipe, root_dtype):
    """(b) Raw clip arrays -> port featurize/encode/consts -> port runner."""
    cha_t = tfeat.clip_stream_features_device(pipe["cha"], pipe["tg"],
                                              pipe["norm"], device="cpu")
    cnt_norm_t = tfeat.compute_cnt_norm(cha_t["encoded"], cha_t["cnt"])
    consts = tstream.build_consts(pipe["norm"], cnt_norm_t, None, cha_t,
                                  device="cpu")
    f0, xs = tfeat.batch_stream_features_device(
        pipe["clips"], pipe["tg"], pipe["norm"], emit_cnt=False,
        device="cpu")
    runner = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], consts, cha_t["bone_parents"],
        deterministic=True, root_dtype=root_dtype, device="cpu")
    out_t = runner(f0, xs)
    _check_against_jax(out_t, pipe["out_j"], consts, _encoded_all(f0, xs))


def test_stochastic_runner_needs_and_follows_its_generator(pipe):
    consts = tstream.build_consts(pipe["norm"], pipe["cnt_norm_j"], None,
                                  pipe["cha_j"], device="cpu")
    runner = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], consts, pipe["cha_j"]["bone_parents"],
        device="cpu")
    f0 = {k: torch.as_tensor(v) for k, v in pipe["frame0_j"].items()}
    xs = {k: torch.as_tensor(v[:20]) for k, v in pipe["xs_j"].items()}
    with pytest.raises(ValueError, match="Generator"):
        runner(f0, xs)
    a = runner(f0, xs, torch.Generator().manual_seed(3))
    b = runner(f0, xs, torch.Generator().manual_seed(3))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.isfinite(a["trans_pos"]).all()
    assert a["trans_pos"].shape == (21, 2, 25, 3)


def test_runner_without_cvae_and_ik(pipe):
    """The NN-only step (no CVAE, IK off) against JAX's."""
    consts = tstream.build_consts(pipe["norm"], pipe["cnt_norm_j"], None,
                                  pipe["cha_j"], device="cpu")
    ik = tstream.IKConfig(enabled=False)
    runner = tstream.make_batch_runner(
        pipe["tg"], None, consts, pipe["cha_j"]["bone_parents"], ik=ik,
        deterministic=True, device="cpu")
    f0 = {k: torch.as_tensor(v) for k, v in pipe["frame0_j"].items()}
    xs = {k: torch.as_tensor(v[:30]) for k, v in pipe["xs_j"].items()}
    out_t = runner(f0, xs)
    runner_j = jstream.make_batch_runner(
        pipe["params"], pipe["jcfg"], None, None, pipe["consts_j"],
        pipe["cha_j"]["bone_parents"], ik=jstream.IKConfig(enabled=False),
        deterministic=True)
    out_j = _np(runner_j(pipe["frame0_j"],
                         {k: v[:30] for k, v in pipe["xs_j"].items()},
                         jax.random.split(jax.random.PRNGKey(7), 2)))
    _check_against_jax(out_t, out_j, consts, _encoded_all(f0, xs))

