"""The port's multi-character serving against the JAX package.

Small widths (as tests/test_torch_stream.py), deterministic CVAE, float32
roots; both sides get the same weights and the same NumPy features.  Two
characters with databases of unequal size (125 and 95 windows) and their
own norms are stacked; three source streams are served with char_ids
[0, 1, 0], so the grouped matcher pads a block (G = 2).  The grouped
matcher must equal JAX's and a brute-force masked argmin exactly; the
multi runner must pick the same character-local rows as JAX's, with
positions and rotations within 1e-3 (PARITY.md:87), and agree with the
port's own single-character runners in picks and in positions within
1e-5 / 1e-4 (tests/test_runtime.py:647-693).  Rotations are held to 1e-3
throughout: the IK hips go through float32 arccos, which amplifies
rounding.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.cli.characterize import (  # noqa: E402
    build_consts as jbuild_consts)
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import matching as jmatch  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.data import dataset as tds  # noqa: E402
from mocha_sigasia2023_torch.data import preprocess as tpre  # noqa: E402
from mocha_sigasia2023_torch.data import windows as twin  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
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
CIDS = np.array([0, 1, 0])


def _np(tree):
    return jax.tree.map(np.array, tree)   # writable copies for torch


def _norm(clip):
    """X/Y norm stats from a clip's windows (as the CLI's demo mode)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    f = tpre.featurize_clip(t(clip["rotations"]), t(clip["positions"]),
                            clip["order"], clip["names"], clip["parents"])
    w = twin.window_features(f, 60, 10, padded=False)
    X, Y, root = tds.window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], f["bone_parents"])
    return tds.compute_norm_stats(X.numpy(), Y.numpy(), root.numpy())


def jax_params(module, init_fn):
    """The JAX pytree holding a port module's weights: the structure from
    ``jax.eval_shape`` of the JAX initializer, the leaves by their dotted
    paths (the port's parameter names)."""
    state = {k: v.numpy() for k, v in module.state_dict().items()}

    def leaf(path, shape):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                       for p in path)
        assert state[key].shape == shape.shape, key
        return jnp.asarray(state[key])

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def build_pipe(n_src=3, src_T=80):
    """Small port and JAX models with the same weights, two characters'
    constants on both sides (from the same NumPy features), and the stream
    features of ``n_src`` source clips (NumPy).  Weights, norms and
    features come from the port, whose functions the other port tests hold
    to JAX's; only the runners under test run on both sides."""
    jcfg = jgen.GeneratorConfig(**SMALL)
    jccfg = jcvae.CVAEConfig(**CVAE_SMALL)
    tg = tgen.init_generator(tgen.GeneratorConfig(**SMALL), seed=11,
                             device="cpu")
    tc = tcvae.init_cvae(tcvae.CVAEConfig(**CVAE_SMALL), seed=12,
                         device="cpu")
    params = jax_params(tg, lambda: jgen.init_generator(
        jax.random.PRNGKey(0), jcfg))
    cparams = jax_params(tc, lambda: jcvae.init_cvae(
        jax.random.PRNGKey(0), jccfg))
    chas = [make_mocha_bvh_data(T=140, seed=10_000, walk_speed=60.0),
            make_mocha_bvh_data(T=110, seed=10_001, walk_speed=40.0)]
    norm = _norm(chas[0])
    consts_j, consts_t, feats = [], [], []
    for i, cha in enumerate(chas):
        cha_t = tfeat.clip_stream_features_device(cha, tg, norm,
                                                  device="cpu")
        cha_np = {k: (v.numpy() if torch.is_tensor(v) else v)
                  for k, v in cha_t.items()}
        cnt_norm = {k: v.numpy() for k, v in tfeat.compute_cnt_norm(
            cha_t["encoded"], cha_t["cnt"]).items()}
        # each character decodes with its own Y stats
        norm_i = norm if i == 0 else _norm(cha)
        consts_j.append(jbuild_consts(norm_i, cnt_norm, None, cha_np))
        consts_t.append(tstream.build_consts(norm_i, cnt_norm, None, cha_np,
                                             device="cpu"))
        feats.append(cha_np)
    clips = [make_mocha_bvh_data(T=src_T, seed=20 + i) for i in range(n_src)]
    frame0, xs = tfeat.batch_stream_features_device(clips, tg, norm,
                                                    device="cpu")
    return dict(jcfg=jcfg, params=params, jccfg=jccfg, cparams=cparams,
                tg=tg, tc=tc, norm=norm, chas=chas, cha_feats=feats,
                consts_j=consts_j, consts_t=consts_t, clips=clips,
                parents=feats[0]["bone_parents"],
                frame0_j={k: v.numpy() for k, v in frame0.items()},
                xs_j={k: v.numpy() for k, v in xs.items()})


def torch_inputs(pipe, drop_cnt=False):
    keep = [k for k in pipe["frame0_j"] if not (drop_cnt and k == "cnt")]
    return ({k: torch.as_tensor(pipe["frame0_j"][k]) for k in keep},
            {k: torch.as_tensor(pipe["xs_j"][k]) for k in keep})


@pytest.fixture(scope="module")
def pipe():
    p = build_pipe()
    stack_j = jstream.stack_consts(p["consts_j"])
    runner_j = jstream.make_batch_runner(
        p["params"], p["jcfg"], p["cparams"], p["jccfg"], stack_j,
        p["parents"], deterministic=True, multi_character=True)
    keys = jax.random.split(jax.random.PRNGKey(7), len(CIDS))
    p["out_j"] = _np(runner_j(p["frame0_j"], p["xs_j"], keys,
                              CIDS.astype(np.int32)))
    p["stack_j"] = stack_j
    p["stack_t"] = tstream.stack_consts(p["consts_t"])
    return p


def _multi_runner(pipe, stack=None, **kw):
    return tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], pipe["stack_t"] if stack is None else stack,
        pipe["parents"], deterministic=True, multi_character=True,
        device="cpu", **kw)


def _close(a, b, atol=1e-5, rtol=1e-4):
    """Identical picks, positions within atol/rtol, rotations within
    POS_TOL."""
    np.testing.assert_array_equal(np.asarray(a["nn_index"]),
                                  np.asarray(b["nn_index"]))
    for k in POS_KEYS:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=atol, rtol=rtol, err_msg=k)
    for k in ROT_KEYS:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=POS_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gids", [[2, 0, 1, 0, 2, 1],     # even, G = 2
                                  [1, 1, 0, 1, 1, 2]])    # skewed, G = 4
def test_nn_index_grouped_matches_jax_and_brute_force(gids):
    r = np.random.RandomState(11)
    C, M, D, T = 3, 17, 31, 5
    db = r.randn(C, M, D).astype(np.float32)
    sq = (db ** 2).sum(-1)
    sq[:, -3:] = np.inf      # pad rows can never win
    db[:, -3:] = 0.0
    gids = np.asarray(gids)
    S = len(gids)
    G = int(np.bincount(gids, minlength=C).max())
    q = r.randn(T, S, D).astype(np.float32)
    q[1, 0] = db[gids[0], 4]    # an exact hit
    got = tmatch.nn_index_grouped(torch.as_tensor(q), torch.as_tensor(db),
                                  torch.as_tensor(sq), torch.as_tensor(gids),
                                  G).numpy()
    want = np.asarray(jmatch.nn_index_grouped(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(sq),
        jnp.asarray(gids, jnp.int32), G))
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == gids[0] * M + 4
    row_char = np.arange(C * M) // M
    for t in range(T):
        for s in range(S):
            d2 = sq.reshape(-1) - 2.0 * (db.reshape(C * M, D) @ q[t, s])
            d2 = np.where(row_char == gids[s], d2, np.inf)
            assert got[t, s] == int(np.argmin(d2)), (t, s)


def test_bf16_database_scores_as_prerounded_f32():
    """A bf16 stack scored in float32 (one character block cast at a time)
    equals a float32 stack pre-rounded through bf16, exactly; scored in
    bf16 it equals JAX's bf16 product's picks."""
    r = np.random.RandomState(3)
    C, M, D = 3, 40, 64
    db = torch.as_tensor(r.randn(C, M, D).astype(np.float32))
    db16 = db.to(torch.bfloat16)
    sq = (db16.float() ** 2).sum(-1)
    gids = torch.as_tensor([0, 2, 2, 1])
    q = torch.as_tensor(r.randn(6, 4, D).astype(np.float32))
    a = tmatch.nn_index_grouped(q, db16, sq, gids, 2, torch.float32)
    b = tmatch.nn_index_grouped(q, db16.float(), sq, gids, 2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = tmatch.nn_index_grouped(q, db16, sq, gids, 2, torch.bfloat16)
    want = jmatch.nn_index_grouped(
        jnp.asarray(q.numpy()).astype(jnp.bfloat16),
        jnp.asarray(db.numpy()).astype(jnp.bfloat16), jnp.asarray(sq.numpy()),
        jnp.asarray(gids.numpy(), jnp.int32), 2)
    assert np.mean(c.numpy() == np.asarray(want)) >= 0.9
    single = tmatch.nn_index(q[:, 0], db16[0], sq[0], torch.float32)
    np.testing.assert_array_equal(
        single.numpy(), tmatch.nn_index(q[:, 0], db16[0].float(),
                                        sq[0]).numpy())


def test_context_index_matches_jax():
    r = np.random.RandomState(5)
    cha_cnt = r.randn(30, 6, 8).astype(np.float32)
    mean = r.randn(6, 8).astype(np.float32)
    std = (r.rand(6, 8) + 0.5).astype(np.float32)
    src = r.randn(4, 6, 8).astype(np.float32)
    src[2] = cha_cnt[13]
    got = tmatch.ContextIndex(cha_cnt, mean, std, device="cpu").query(
        torch.as_tensor(src)).numpy()
    want = np.asarray(jmatch.ContextIndex(cha_cnt, mean, std).query(
        jnp.asarray(src)))
    np.testing.assert_array_equal(got, want)
    assert got[2] == 13
    np.testing.assert_array_equal(
        tmatch.normalize_cnt(torch.as_tensor(src), torch.as_tensor(mean),
                             torch.as_tensor(std)).numpy(),
        np.asarray(jmatch.normalize_cnt(src, mean, std)))


# ---------------------------------------------------------------------------
# the character stack
# ---------------------------------------------------------------------------


def test_stack_pad_and_cast_match_jax(pipe):
    stack_t, stack_j = pipe["stack_t"], pipe["stack_j"]
    for name in tstream.RuntimeConsts._fields:
        a, b = getattr(stack_t, name).numpy(), np.asarray(getattr(stack_j,
                                                                  name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=name)
    assert torch.isinf(stack_t.cha_cnt_sq[1, 95:]).all()
    assert not stack_t.cha_encoded[1, 95:].any()
    one = tstream.pad_character_database(pipe["consts_t"][1], 125)
    for name in tstream.DATABASE_FIELDS:
        assert torch.equal(getattr(one, name), getattr(stack_t, name)[1])
    with pytest.raises(ValueError, match="rows > target"):
        tstream.pad_character_database(pipe["consts_t"][0], 100)
    cast = tstream.cast_database(stack_t, torch.bfloat16)
    cast_j = jstream.cast_database(stack_j, jnp.bfloat16)
    for name in ("cha_encoded", "cha_cnt_flat"):
        assert getattr(cast, name).dtype == torch.bfloat16
        np.testing.assert_allclose(
            getattr(cast, name).float().numpy(),
            np.asarray(getattr(cast_j, name)).astype(np.float32),
            atol=1e-2, rtol=1e-2, err_msg=name)
    assert cast.cha_cnt_sq.dtype == torch.float32


# ---------------------------------------------------------------------------
# the multi-character runner
# ---------------------------------------------------------------------------


def test_multi_runner_matches_jax(pipe):
    f0, xs = torch_inputs(pipe)
    out_t = _multi_runner(pipe)(f0, xs, char_ids=CIDS)
    out_j = pipe["out_j"]
    np.testing.assert_array_equal(out_t["nn_index"].numpy(),
                                  out_j["nn_index"])
    assert out_t["nn_index"].max() < 125    # character-local
    for k in POS_KEYS + ROT_KEYS:
        err = np.abs(out_t[k].numpy() - out_j[k]).max()
        assert err <= POS_TOL, (k, err)


def test_multi_runner_matches_single_character_runners(pipe):
    f0, xs = torch_inputs(pipe)
    multi = _multi_runner(pipe)(f0, xs, char_ids=CIDS)
    for c in (0, 1):
        s = np.nonzero(CIDS == c)[0]
        single = tstream.make_batch_runner(
            pipe["tg"], pipe["tc"], pipe["consts_t"][c], pipe["parents"],
            deterministic=True, device="cpu")(
                {k: v[s] for k, v in f0.items()},
                {k: v[:, s] for k, v in xs.items()})
        _close({k: v[:, s] for k, v in multi.items()}, single)


def test_unequal_counts_match_equal_counts(pipe):
    """2+1 streams pad the matcher's block of character 1 (G = 2); the
    padded session equals the even 2+2 session stream for stream."""
    f0, xs = torch_inputs(pipe)
    f0_4 = {k: torch.cat([v, v[1:2]]) for k, v in f0.items()}
    xs_4 = {k: torch.cat([v, v[:, 1:2]], dim=1) for k, v in xs.items()}
    runner = _multi_runner(pipe)
    equal = runner(f0_4, xs_4, char_ids=[0, 1, 0, 1])
    unequal = runner(f0, xs, char_ids=CIDS)
    _close(unequal, {k: v[:, :3] for k, v in equal.items()})


def test_dropped_cnt_matches_carried(pipe):
    runner = _multi_runner(pipe)
    a = runner(*torch_inputs(pipe), char_ids=CIDS)
    b = runner(*torch_inputs(pipe, drop_cnt=True), char_ids=CIDS)
    _close(a, b)


def test_chunked_multi_equals_monolithic(pipe):
    f0, xs = torch_inputs(pipe, drop_cnt=True)
    runner = _multi_runner(pipe)
    a = runner(f0, xs, char_ids=CIDS)
    b = runner.chunked({k: v.numpy() for k, v in f0.items()},
                       {k: v.numpy() for k, v in xs.items()},
                       char_ids=torch.as_tensor(CIDS), tchunk=23)
    _close(a, b, atol=1e-6, rtol=0)


def test_char_ids_are_checked(pipe):
    f0, xs = torch_inputs(pipe)
    xs = {k: v[:3] for k, v in xs.items()}
    runner = _multi_runner(pipe)
    for bad in ([0, 2, 0], [0, -1, 0]):
        with pytest.raises(ValueError, match=r"char_ids must be in \[0, 2\)"):
            runner(f0, xs, char_ids=bad)
    with pytest.raises(ValueError, match="2 char_ids for 3 streams"):
        runner(f0, xs, char_ids=[0, 1])
    with pytest.raises(ValueError, match="needs char_ids"):
        runner(f0, xs)
    with pytest.raises(ValueError, match="stack_consts"):
        _multi_runner(pipe, stack=pipe["consts_t"][0])
    single = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], pipe["consts_t"][0], pipe["parents"],
        deterministic=True, device="cpu")
    with pytest.raises(ValueError, match="multi_character=True"):
        single(f0, xs, char_ids=CIDS)


@pytest.mark.parametrize("multi", [False, True])
def test_bf16_database_equals_prerounded_f32(pipe, multi):
    """cast_database's bf16 stack serves exactly as a float32 stack whose
    rows were pre-rounded through bf16: identical picks, 1e-6."""
    def rounded(c):
        return c._replace(**{n: getattr(c, n).to(torch.bfloat16).float()
                             for n in ("cha_encoded", "cha_cnt_flat")})

    f0, xs = torch_inputs(pipe)
    consts = pipe["stack_t"] if multi else pipe["consts_t"][0]
    outs = []
    for c in (tstream.cast_database(consts, torch.bfloat16), rounded(consts)):
        runner = tstream.make_batch_runner(
            pipe["tg"], pipe["tc"], c, pipe["parents"], deterministic=True,
            multi_character=multi, device="cpu")
        outs.append(runner(f0, xs, char_ids=CIDS if multi else None))
    _close(*outs, atol=1e-6, rtol=0)
