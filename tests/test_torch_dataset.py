"""The port's offline dataset path against the JAX package: the windowed
dataset and its norm stats, the encoder passes behind ``cnt_norm.npz`` and
the per-character feature files, and the chain of CLIs.

Each test set is made here from NumPy seeds: three synthetic BVH clips of
140 frames (Neutral_Princess walking and running, Angry_Clown walking),
mirrored by the build, and a narrow generator (dim 32, 2 heads, depth 1)
from the JAX initializer, crossing to the port as reference ``.pt`` files
as tests/test_torch_cli.py feeds them.  Bars: window features and norm
stats 2e-4 (the featurize tolerance), encoded 5e-4 and cnt 5e-3
(tests/test_features.py:77-78), labels, contacts, range bookkeeping and
batch order exact; characterized positions 1e-3 and angles 1e-3 degrees
(5e-2 in the IK-adjusted ``Ours_`` files), as tests/test_torch_cli.py
holds them.  The JAX characterize CLI runs in a subprocess (it switches on
jax_enable_x64 for its process); the other JAX CLIs run in-process.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from mocha_sigasia2023_tpu.cli import collect_features as jcf  # noqa: E402
from mocha_sigasia2023_tpu.cli import generate_database as jgd  # noqa: E402
from mocha_sigasia2023_tpu.data import dataset as jds  # noqa: E402
from mocha_sigasia2023_tpu.io import database as jdb  # noqa: E402
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import features as jfeat  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize as tchar  # noqa: E402
from mocha_sigasia2023_torch.cli import collect_features as tcf  # noqa: E402
from mocha_sigasia2023_torch.cli import generate_database as tgd  # noqa: E402
from mocha_sigasia2023_torch.data import dataset as tds  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as tfeat  # noqa: E402

from test_torch_cli import (  # noqa: E402
    CVAE_SMALL, SMALL, _compare_dirs, _config_text)
from test_torch_convert import save_reference_checkpoints  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 2e-4
ENC_TOL, CNT_TOL = 5e-4, 5e-3
CLIPS = (("Walk_Neutral_Princess_001", 140), ("Run_Neutral_Princess_002", 140),
         ("Walk_Angry_Clown_003", 140))
STYLES, ACTIONS = ["17"], ["6", "7"]     # Neutral_Princess; Run, Walk


def _np(tree):
    return jax.tree.map(np.array, tree)


def _start_jax_characterize(d, args):
    code = ("import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from mocha_sigasia2023_tpu.cli import characterize as c\n"
            f"c.main({args!r})\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MOCHA_COMPILATION_CACHE=str(d / "jax_cache_char"))
    with open(d / "jax_char.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], cwd=str(d),
                                env=env, stdout=log, stderr=log)


def _char_args(d, data, out):
    return ["--config", str(d / "config.yaml"),
            "--src", str(d / "bvh" / f"{CLIPS[2][0]}.bvh"),
            "--cha", str(d / "bvh" / f"{CLIPS[0][0]}.bvh"),
            "--gen-ckpt", str(d / "gen.pt"), "--cvae-ckpt", str(d / "cvae.pt"),
            "--norm", str(data / "norm.npz"),
            "--cnt-norm", str(data / "cnt_norm.npz"),
            "--out", str(out), "--deterministic"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory, request):
    """The chain generate -> MotionDataset -> cnt-norm -> character through
    both packages' CLIs on the same BVH files and .pt weights; the JAX
    characterize CLI starts in a subprocess on the JAX chain's files."""
    d = tmp_path_factory.mktemp("dataset_chain")
    (d / "bvh").mkdir()
    for i, (name, T) in enumerate(CLIPS):
        tbvh.save(str(d / "bvh" / f"{name}.bvh"),
                  make_mocha_bvh_data(T=T, seed=90 + i,
                                      walk_speed=50.0 + 15 * i))
    (d / "config.yaml").write_text(_config_text())
    jcfg = jgen.GeneratorConfig(**SMALL)
    params = _np(jgen.init_generator(jax.random.PRNGKey(41), jcfg))
    cparams = _np(jcvae.init_cvae(jax.random.PRNGKey(42),
                                  jcvae.CVAEConfig(**CVAE_SMALL)))
    save_reference_checkpoints(d, params, cparams)
    common = ["--config", str(d / "config.yaml"), "--gen-ckpt",
              str(d / "gen.pt")]
    character = ["--styles", *STYLES, "--actions", *ACTIONS]

    jdir, tdir = d / "jax", d / "torch"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOCHA_COMPILATION_CACHE", str(d / "jax_cache"))
        jgd.main(["--bvh-dir", str(d / "bvh"), "--out", str(jdir)])
        jds.MotionDataset(str(jdir))
        jcf.main(["cnt-norm", *common, "--data-dir", str(jdir)])
        proc = _start_jax_characterize(d, _char_args(d, jdir, d / "jax_out"))
        request.addfinalizer(proc.kill)
        jcf.main(["character", *common, "--data-dir", str(jdir), *character,
                  "--out", str(jdir / "cha_feature.npz")])

    cpu = ["--device", "cpu"]
    tgd.main(["--bvh-dir", str(d / "bvh"), "--out", str(tdir), *cpu])
    dataset = tds.MotionDataset(str(tdir), device="cpu")
    tcf.main(["cnt-norm", *common, "--data-dir", str(tdir), *cpu])
    tcf.main(["character", *common, "--data-dir", str(tdir), *character,
              "--out", str(tdir / "cha_feature.npz"), *cpu])
    tg = convert.load_reference_generator_checkpoint(
        str(d / "gen.pt"), tgen.GeneratorConfig(**SMALL), device="cpu")
    return dict(dir=d, jdir=jdir, tdir=tdir, proc=proc, dataset=dataset,
                params=params, jcfg=jcfg, tg=tg)


def _load_npz(path):
    return dict(np.load(str(path)))


def test_database_files_agree(chain):
    got = jdb.load_database(str(chain["tdir"] / "database.bin"))
    want = jdb.load_database(str(chain["jdir"] / "database.bin"))
    assert len(got["range_starts"]) == 2 * len(CLIPS)
    for k in want:
        if want[k].dtype == np.float32:
            np.testing.assert_allclose(got[k], want[k], atol=FEAT_TOL,
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_motion_dataset_matches_jax(chain, tmp_path):
    """Both datasets over the same database.bin, each writing its own
    norm.npz."""
    for name in ("t", "j"):
        (tmp_path / name).mkdir()
        shutil.copy(chain["tdir"] / "database.bin", tmp_path / name)
    got = tds.MotionDataset(str(tmp_path / "t"), device="cpu")
    want = jds.MotionDataset(str(tmp_path / "j"))
    assert len(got) == len(want) == 2 * len(CLIPS) * 5   # 5 windows a range
    for k in ("X", "Y", "root"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=FEAT_TOL, rtol=0, err_msg=k)
    for k in ("contact", "label", "action", "parents"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    norm_t = _load_npz(tmp_path / "t" / "norm.npz")
    norm_j = _load_npz(tmp_path / "j" / "norm.npz")
    assert set(norm_t) == set(norm_j) == set(got.norm)
    for k in norm_j:
        np.testing.assert_allclose(norm_t[k], norm_j[k], atol=FEAT_TOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_array_equal(got.norm[k], norm_t[k])
    item, want_item = got[3], want[3]
    assert set(item) == set(want_item)
    # an existing norm.npz is read, not rewritten
    stamp = os.stat(tmp_path / "t" / "norm.npz").st_mtime_ns
    tds.MotionDataset(str(tmp_path / "t"), device="cpu")
    assert os.stat(tmp_path / "t" / "norm.npz").st_mtime_ns == stamp


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 5),
                                                     (True, False, 7),
                                                     (False, False, 4)])
def test_iterate_batches_same_order(chain, shuffle, drop_last, batch):
    ds = chain["dataset"]
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, epoch=2)
    got = list(tds.iterate_batches(ds, batch, **kw))
    want = list(jds.iterate_batches(ds, batch, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_compute_window_features_chunking_is_exact(chain):
    """The chunked device pass gives what one chunk gives."""
    ds = chain["dataset"]
    db = jdb.load_database(str(chain["tdir"] / "database.bin"))
    idx = np.concatenate([np.arange(s, s + 60)[None] for s in (0, 20, 150)])
    args = [db[k][idx] for k in ("bone_rotations", "bone_positions",
                                 "bone_velocities", "bone_angular_velocities")]
    one = tds.compute_window_features(*args, db["bone_parents"], device="cpu")
    two = tds.compute_window_features(*args, db["bone_parents"], batch=2,
                                      device="cpu")
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one[0][:2], ds.X[:2])


def test_encode_database_matches_jax(chain):
    db = jdb.load_database(str(chain["tdir"] / "database.bin"))
    norm = _load_npz(chain["tdir"] / "norm.npz")
    enc, cnt, styles, actions = tfeat.encode_database(db, chain["tg"], norm,
                                                      device="cpu")
    jenc, jcnt, jstyles, jactions = jfeat.encode_database(
        db, chain["params"], chain["jcfg"], norm)
    assert enc.shape == jenc.shape == (30, 90, 32)
    np.testing.assert_allclose(enc.numpy(), jenc, atol=ENC_TOL, rtol=0)
    np.testing.assert_allclose(cnt.numpy(), jcnt, atol=CNT_TOL, rtol=0)
    np.testing.assert_array_equal(styles, jstyles)
    np.testing.assert_array_equal(actions, jactions)
    idx, s, a = tds.database_window_features(
        db, clip_filter=lambda style, action: action == 6)
    jidx, js, ja = jfeat.database_window_features(
        db, clip_filter=lambda style, action: action == 6)
    for g, w in ((idx, jidx), (s, js), (a, ja)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no clips"):
        tds.database_window_features(db, clip_filter=lambda s, a: False)
    stats = tfeat.compute_cnt_norm(enc, cnt)
    jstats = jfeat.compute_cnt_norm(jenc, jcnt)
    for k in jstats:
        np.testing.assert_allclose(stats[k].numpy(), jstats[k],
                                   atol=CNT_TOL if "std" in k or k == "mean"
                                   else ENC_TOL, rtol=0, err_msg=k)


def test_collect_character_features_matches_jax(chain):
    db = jdb.load_database(str(chain["tdir"] / "database.bin"))
    norm = _load_npz(chain["tdir"] / "norm.npz")
    kw = dict(style_labels=[17], action_labels=[6, 7])
    got = tfeat.collect_character_features(db, chain["tg"], norm,
                                           device="cpu", **kw)
    want = jfeat.collect_character_features(db, chain["params"],
                                            chain["jcfg"], norm, **kw)
    assert set(got) == set(want)
    # four ranges of 140 frames: range(60, 140) gives 80 windows each
    np.testing.assert_array_equal(got["range_starts"], [0, 80, 160, 240])
    np.testing.assert_array_equal(got["range_stops"], [80, 160, 240, 320])
    for k in ("range_starts", "range_stops", "action_label"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["encoded"], want["encoded"], atol=ENC_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["cnt"], want["cnt"], atol=CNT_TOL, rtol=0)


def test_clip_stream_features_host_path_matches_jax(chain):
    """The port's one clip path (the device form, on the CPU here) against
    the JAX package's host path, which recomputes X / Y / root per window:
    the same rows in the same order."""
    clip = tbvh.load(str(chain["dir"] / "bvh" / f"{CLIPS[2][0]}.bvh"))
    norm = _load_npz(chain["tdir"] / "norm.npz")
    got = tfeat.clip_stream_features_device(clip, chain["tg"], norm,
                                            window=60, device="cpu")
    want = jfeat.clip_stream_features(clip, chain["params"], chain["jcfg"],
                                      norm)
    assert set(got) == set(want)
    assert got["encoded"].shape == (140 - 15, 90, 32)
    for k, v in want.items():
        if k == "bone_names":
            assert list(got[k]) == list(v)
        elif k in ("bone_parents", "contact_last"):
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        else:
            tol = {"encoded": ENC_TOL, "cnt": CNT_TOL}.get(k, FEAT_TOL)
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                       atol=tol, rtol=0, err_msg=k)


def test_cli_feature_files_agree(chain):
    for name in ("norm.npz", "cnt_norm.npz"):
        got = _load_npz(chain["tdir"] / name)
        want = _load_npz(chain["jdir"] / name)
        assert set(got) == set(want), name
        tol = CNT_TOL if name == "cnt_norm.npz" else FEAT_TOL
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                       err_msg=f"{name} {k}")
    got = _load_npz(chain["tdir"] / "cha_feature.npz")
    want = _load_npz(chain["jdir"] / "cha_feature.npz")
    assert set(got) == set(want)
    for k in ("range_starts", "range_stops", "action_label"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["encoded"], want["encoded"], atol=ENC_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["cnt"], want["cnt"], atol=CNT_TOL, rtol=0)


def test_characterize_on_the_chain_matches_jax(chain):
    """characterize --device cpu on the JAX chain's norm files against the
    JAX CLI on the same files; and on the port chain's own files, every
    output finite with the clip's frame count."""
    d = chain["dir"]
    tchar.main(_char_args(d, chain["jdir"], d / "torch_out")
               + ["--device", "cpu"])
    rc = chain["proc"].wait(timeout=600)
    assert rc == 0, (d / "jax_char.log").read_text()[-4000:]
    names, frames = _compare_dirs(d / "torch_out", d / "jax_out")
    assert len(names) == 3 and frames == [140 - 15] * 3
    own = d / "torch_own"
    tchar.main(_char_args(d, chain["tdir"], own) + ["--device", "cpu"])
    for f in sorted(os.listdir(own)):
        out = tbvh.load(str(own / f))
        assert out["rotations"].shape[0] == 140 - 15, f
        assert np.isfinite(out["rotations"]).all(), f
        assert np.isfinite(out["positions"]).all(), f


def test_dataset_clis_default_to_cuda(chain, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgd.main(["--bvh-dir", str(chain["dir"] / "bvh"),
                  "--out", str(tmp_path / "db")])
    assert not (tmp_path / "db").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcf.main(["cnt-norm", "--data-dir", str(chain["tdir"]),
                  "--random-init"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.MotionDataset(str(chain["tdir"]))
