"""The port's clip featurization and stream features against JAX.

Two synthetic clips (NumPy, from seeds) go through the JAX package and the
port with the same small generator.  Features are held at atol 2e-4, the
bound of the JAX package's own device-vs-host featurizer test
(runtime/features.py:203-205); contacts must be equal.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.data import dataset as jds  # noqa: E402
from mocha_sigasia2023_tpu.data import preprocess as jpre  # noqa: E402
from mocha_sigasia2023_tpu.data import synthetic as jsyn  # noqa: E402
from mocha_sigasia2023_tpu.data import windows as jwin  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import features as jfeat  # noqa: E402

from mocha_sigasia2023_torch.data import dataset as tds  # noqa: E402
from mocha_sigasia2023_torch.data import preprocess as tpre  # noqa: E402
from mocha_sigasia2023_torch.data import synthetic as tsyn  # noqa: E402
from mocha_sigasia2023_torch.data import windows as twin  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as tfeat  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
TOL = 2e-4
STREAM_KEYS = ("encoded", "cnt", "pos_last", "rot_last", "vel_last",
               "ang_last", "rvel_last", "rang_last", "hips_speed_mean")


def _t(clip, key):
    return torch.as_tensor(np.asarray(clip[key], np.float32))


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    jcfg = jgen.GeneratorConfig(**SMALL)
    params = jgen.init_generator(jax.random.PRNGKey(3), jcfg)
    tg = convert.generator_from_jax(jax.tree.map(np.asarray, params),
                                    tgen.GeneratorConfig(**SMALL),
                                    device="cpu")
    cha = jsyn.make_mocha_bvh_data(T=160, seed=100, walk_speed=60.0)
    f0 = jpre.featurize_clip_jit(cha)
    w = jwin.window_features(f0, 60, 10, padded=False)
    X, Y, root = jds.window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], f0["bone_parents"])
    norm = jds.compute_norm_stats(np.asarray(X), np.asarray(Y),
                                  np.asarray(root))
    clips = [jsyn.make_mocha_bvh_data(T=95, seed=i) for i in range(2)]
    return dict(jcfg=jcfg, params=params, tg=tg, cha=cha, norm=norm,
                clips=clips, X=X, Y=Y, root=root, w=w, f0=f0)


def test_synthetic_clips_equal():
    for seed, speed in ((0, 80.0), (7, 60.0)):
        a = tsyn.make_mocha_bvh_data(T=50, seed=seed, walk_speed=speed)
        b = jsyn.make_mocha_bvh_data(T=50, seed=seed, walk_speed=speed)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("T,step", [(95, 1), (160, 20), (40, 7)])
def test_window_indices_and_gather(T, step):
    for a, b in zip(twin.padded_window_indices(T, 60, step),
                    jwin.padded_window_indices(T, 60, step)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(twin.full_window_indices(T, 60, step),
                                  jwin.full_window_indices(T, 60, step))
    x = np.random.RandomState(T).randn(T, 5, 3).astype(np.float32)
    idx, pad = jwin.padded_window_indices(T, 60, step)
    np.testing.assert_array_equal(
        twin.gather_windows(torch.as_tensor(x), idx, pad).numpy(),
        np.asarray(jwin.gather_windows(x, idx, pad)))


def test_savgol_and_median_vote():
    rng = np.random.RandomState(1)
    x = rng.randn(80, 1, 3).astype(np.float32)
    for window in (15, 31):
        _close(tpre.savgol_filter(torch.as_tensor(x)[None], window, 3)[0],
               jpre.savgol_filter(jnp.asarray(x), window, 3), 1e-5)
    c = rng.rand(80, 2) < 0.5
    np.testing.assert_array_equal(
        tpre.median_vote(torch.as_tensor(c)[None])[0].numpy(),
        np.asarray(jpre.median_vote(jnp.asarray(c))))


def test_featurize_clip_single_and_batched(setup):
    clips = setup["clips"]
    c0 = clips[0]
    ref = [jpre.featurize_clip_jit(c) for c in clips]
    batched = tpre.featurize_clip(
        torch.stack([_t(c, "rotations") for c in clips]),
        torch.stack([_t(c, "positions") for c in clips]),
        c0["order"], c0["names"], c0["parents"])
    np.testing.assert_array_equal(batched["bone_parents"],
                                  ref[0]["bone_parents"])
    assert batched["bone_names"] == ref[0]["bone_names"]
    for i, (c, r) in enumerate(zip(clips, ref)):
        single = tpre.featurize_clip(_t(c, "rotations"), _t(c, "positions"),
                                     c["order"], c["names"], c["parents"])
        for k in ("positions", "velocities", "rotations",
                  "angular_velocities"):
            _close(single[k], r[k], msg=k)
            _close(batched[k][i], r[k], msg=k)
        np.testing.assert_array_equal(single["contacts"].numpy(),
                                      np.asarray(r["contacts"]))
        np.testing.assert_array_equal(batched["contacts"][i].numpy(),
                                      np.asarray(r["contacts"]))


def test_window_features_and_norm_stats(setup):
    s = setup
    f0 = {k: (torch.as_tensor(np.array(v)) if k not in
              ("bone_parents", "bone_names") else v)
          for k, v in s["f0"].items()}
    w = twin.window_features(f0, 60, 10, padded=False)
    for k in w:
        _close(w[k].numpy().astype(np.float32),
               np.asarray(s["w"][k]).astype(np.float32), msg=k)
    X, Y, root = tds.window_xy_features(
        w["rotations"], w["positions"], w["velocities"],
        w["angular_velocities"], f0["bone_parents"])
    _close(X, s["X"], msg="X")
    _close(Y, s["Y"], msg="Y")
    _close(root, s["root"], msg="root")
    norm = tds.compute_norm_stats(X.numpy(), Y.numpy(), root.numpy())
    for k in norm:
        _close(norm[k], s["norm"][k], msg=k)
    wp = twin.window_features(f0, 60, 20, padded=True)
    wj = jwin.window_features(s["f0"], 60, 20, padded=True)
    for k in wp:
        _close(wp[k].numpy().astype(np.float32),
               np.asarray(wj[k]).astype(np.float32), msg=k)


def test_batch_stream_features_device(setup):
    s = setup
    f0_j, xs_j = jfeat.batch_stream_features_device(
        s["clips"], s["params"], s["jcfg"], s["norm"])
    f0_t, xs_t = tfeat.batch_stream_features_device(
        s["clips"], s["tg"], s["norm"], device="cpu")
    assert set(f0_t) == set(f0_j)
    for k in STREAM_KEYS:
        assert tuple(xs_t[k].shape) == tuple(xs_j[k].shape), k
        _close(f0_t[k], f0_j[k], msg=k)
        _close(xs_t[k], xs_j[k], msg=k)
    np.testing.assert_array_equal(f0_t["contact_last"].numpy(),
                                  np.asarray(f0_j["contact_last"]))
    np.testing.assert_array_equal(xs_t["contact_last"].numpy(),
                                  np.asarray(xs_j["contact_last"]))
    # chunking does not change results
    f0_c, xs_c = tfeat.batch_stream_features_device(
        s["clips"], s["tg"], s["norm"], chunk=32, emit_cnt=False,
        device="cpu")
    assert "cnt" not in xs_c
    _close(xs_c["encoded"], xs_t["encoded"], 1e-5)


def test_clip_stream_features_and_cnt_norm(setup):
    s = setup
    j = jfeat.clip_stream_features_device(s["cha"], s["params"], s["jcfg"],
                                          s["norm"])
    t = tfeat.clip_stream_features_device(s["cha"], s["tg"], s["norm"],
                                          device="cpu")
    np.testing.assert_array_equal(t["bone_parents"], j["bone_parents"])
    assert list(t["bone_names"]) == list(j["bone_names"])
    for k in STREAM_KEYS:
        _close(t[k], j[k], msg=k)
    np.testing.assert_array_equal(t["contact_last"].numpy(),
                                  np.asarray(j["contact_last"]))
    cn_t = tfeat.compute_cnt_norm(t["encoded"], t["cnt"])
    cn_j = jfeat.compute_cnt_norm(np.asarray(j["encoded"]),
                                  np.asarray(j["cnt"]))
    for k in cn_j:
        _close(cn_t[k], cn_j[k], msg=k)


def test_tail_forms_match_jax():
    rng = np.random.RandomState(7)
    pos = rng.randn(5, 4, 25, 3).astype(np.float32)
    rot = rng.randn(5, 4, 25, 4).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    _close(tfeat._tail_vel(torch.as_tensor(pos)),
           jfeat._tail_vel(jnp.asarray(pos)), 1e-5)
    _close(tfeat._tail_ang(torch.as_tensor(rot)),
           jfeat._tail_ang(jnp.asarray(rot)), 1e-4)
