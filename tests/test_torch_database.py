"""The port's database codec, database build, mirroring and whole-clip
padding against the JAX package.

The codec is NumPy in both packages: the same dict must give byte-identical
files, and each package must read the other's.  The database build runs
on three synthetic BVH files (140 frames, mirrored): integer blocks and
contacts identical, float blocks within 2e-4 (the featurize tolerance of
tests/test_torch_features.py), and the port's own build byte-stable from
run to run (as tests/test_io_preprocess.py holds the JAX build).
Mirroring is held to the JAX ``animation_mirror`` within 1e-5 and to the
mirrored ``featurize_clip_jit`` within 2e-4; the reflect padding is exact.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.cli import generate_database as jgd  # noqa: E402
from mocha_sigasia2023_tpu.data import preprocess as jpre  # noqa: E402
from mocha_sigasia2023_tpu.data import windows as jwin  # noqa: E402
from mocha_sigasia2023_tpu.io import database as jdb  # noqa: E402
from mocha_sigasia2023_tpu.kinematics import quat as jquat  # noqa: E402
from mocha_sigasia2023_tpu.utils import get_config as jget_config  # noqa: E402

from mocha_sigasia2023_torch.cli import generate_database as tgd  # noqa: E402
from mocha_sigasia2023_torch.data import preprocess as tpre  # noqa: E402
from mocha_sigasia2023_torch.data import windows as twin  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.io import database as tdb  # noqa: E402
from mocha_sigasia2023_torch.kinematics import quat as tquat  # noqa: E402
from mocha_sigasia2023_torch.utils import get_config  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 2e-4
MIRROR_TOL = 1e-5
CLIP_NAMES = ("Walk_Neutral_Princess_001", "Run_Angry_Clown_002",
              "Walk_Happy_Ogre_003")
INT_KEYS = ("bone_parents", "range_starts", "range_stops", "style_labels",
            "action_labels", "contact_states")
FLOAT_KEYS = ("bone_positions", "bone_velocities", "bone_rotations",
              "bone_angular_velocities")


def _random_db(seed, nframes=37, nbones=5, nranges=3, alias=False):
    rng = np.random.RandomState(seed)
    db = {"bone_positions": rng.randn(nframes, nbones, 3),
          "bone_velocities": rng.randn(nframes, nbones, 3),
          "bone_rotations": rng.randn(nframes, nbones, 4),
          "bone_angular_velocities": rng.randn(nframes, nbones, 3),
          "bone_parents": np.arange(nbones) - 1,
          "range_starts": np.sort(rng.randint(0, nframes, nranges)),
          "range_stops": np.sort(rng.randint(0, nframes, nranges)),
          "style_labels": rng.randint(0, 30, nranges),
          "contact_states": rng.rand(nframes, 2) > 0.5}
    db["content_labels" if alias else "action_labels"] = rng.randint(
        0, 14, nranges)
    return db


@pytest.mark.parametrize("alias", [False, True])
def test_save_database_byte_identical_to_jax(tmp_path, alias):
    """Float64 and bool inputs are cast as the JAX writer casts them; the
    ``content_labels`` alias stands in for ``action_labels``."""
    db = _random_db(3, alias=alias)
    tdb.save_database(str(tmp_path / "t.bin"), db)
    jdb.save_database(str(tmp_path / "j.bin"), db)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_load_database_round_trips_both_ways(tmp_path):
    db = _random_db(4, nframes=50, nbones=25, nranges=6)
    tdb.save_database(str(tmp_path / "t.bin"), db)
    jdb.save_database(str(tmp_path / "j.bin"), db)
    for path in ("t.bin", "j.bin"):
        got = tdb.load_database(str(tmp_path / path))
        want = jdb.load_database(str(tmp_path / path))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["content_labels"],
                                      got["action_labels"])
        np.testing.assert_array_equal(
            got["bone_rotations"], db["bone_rotations"].astype(np.float32))
        np.testing.assert_array_equal(got["contact_states"],
                                      db["contact_states"].astype(np.uint8))


def test_features_codec_round_trips_both_ways(tmp_path):
    rng = np.random.RandomState(5)
    feats, off, scale = rng.randn(7, 11), rng.randn(11), rng.rand(11)
    tdb.save_features(str(tmp_path / "t.bin"), feats, off, scale)
    jdb.save_features(str(tmp_path / "j.bin"), feats, off, scale)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    got = tdb.load_features(str(tmp_path / "j.bin"))
    want = jdb.load_features(str(tmp_path / "t.bin"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["features"], feats.astype(np.float32))


def test_dataset_config_copy_reads_as_the_jax_file():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = get_config(tgd.DEFAULT_DATASET_CONFIG)
    assert port == jget_config(jgd.DEFAULT_DATASET_CONFIG)
    assert tgd.DEFAULT_DATASET_CONFIG.startswith(
        os.path.join(here, "mocha_sigasia2023_torch"))
    assert len(port["mocha_style_names"]) == 30
    assert port["mocha_action_names"][6:8] == ["Run", "Walk"]


def test_label_from_name():
    vocab = get_config(tgd.DEFAULT_DATASET_CONFIG)["mocha_style_names"]
    for stem in CLIP_NAMES + ("Loco_Walk_Neutral_AverageJoe_001", "x"):
        try:
            want = jgd.label_from_name(stem, vocab)
        except ValueError:
            with pytest.raises(ValueError, match="no label"):
                tgd.label_from_name(stem, vocab)
            continue
        assert tgd.label_from_name(stem, vocab) == want


@pytest.fixture(scope="module")
def bvh_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bvh")
    for i, name in enumerate(CLIP_NAMES):
        tbvh.save(str(d / f"{name}.bvh"),
                  make_mocha_bvh_data(T=140, seed=60 + i,
                                      walk_speed=50.0 + 10 * i))
    return d


def _build(module, bvh_dir, **kw):
    cfg = get_config(tgd.DEFAULT_DATASET_CONFIG)
    files = sorted(p for p in bvh_dir.rglob("*.bvh"))
    return module.build_database(files, cfg["mocha_style_names"],
                                 cfg["mocha_action_names"], **kw)


def test_build_database_matches_jax(bvh_dir):
    got = _build(tgd, bvh_dir, device="cpu")
    want = _build(jgd, bvh_dir)
    assert set(got) == set(want)
    assert len(got["range_starts"]) == 2 * len(CLIP_NAMES)
    for k in INT_KEYS:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOAT_KEYS:
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], atol=FEAT_TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(got["style_labels"], [5, 5, 11, 11, 17, 17])
    np.testing.assert_array_equal(got["action_labels"], [6, 6, 7, 7, 7, 7])


def test_build_database_is_byte_stable(bvh_dir, tmp_path):
    """Same BVH in -> bit-identical database.bin out, through the CLI."""
    for name in ("a", "b"):
        tgd.main(["--bvh-dir", str(bvh_dir), "--out", str(tmp_path),
                  "--name", f"{name}.bin", "--no-mirror", "--device", "cpu"])
    a = (tmp_path / "a.bin").read_bytes()
    assert a == (tmp_path / "b.bin").read_bytes()
    db = tdb.load_database(str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(db["range_stops"], [140, 280, 420])


def test_to_xform_matches_jax():
    q = np.random.RandomState(6).randn(40, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    got = tquat.to_xform(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jquat.to_xform(jnp.asarray(q))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[..., :2],
                               tquat.to_xform_xy(torch.as_tensor(q)).numpy(),
                               atol=0, rtol=0)


def _local_pose(clip):
    rot = jquat.unroll(jquat.from_euler(jnp.radians(jnp.asarray(
        clip["rotations"], jnp.float32)), order=clip["order"]))
    pos = jnp.asarray(clip["positions"], jnp.float32) * 0.01
    return np.array(rot), np.array(pos)


def test_mirror_map_and_animation_mirror_match_jax():
    clip = make_mocha_bvh_data(T=50, seed=70)
    names, parents = clip["names"], np.asarray(clip["parents"])
    np.testing.assert_array_equal(tpre.mirror_map(list(names)),
                                  jpre.mirror_map(list(names)))
    rot, pos = _local_pose(clip)
    got = tpre.animation_mirror(torch.as_tensor(rot), torch.as_tensor(pos),
                                names, parents)
    want = jpre.animation_mirror(jnp.asarray(rot), jnp.asarray(pos), names,
                                 parents)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MIRROR_TOL,
                                   rtol=0)
    # mirroring twice gives the pose back
    back = tpre.animation_mirror(*got, names, parents)
    np.testing.assert_allclose(back[1].numpy(), pos, atol=MIRROR_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_featurize_clip_mirror_matches_jax(batched):
    clips = [make_mocha_bvh_data(T=100, seed=71 + i) for i in range(2)]
    c0 = clips[0]
    rot = torch.as_tensor(np.stack([c["rotations"] for c in clips]),
                          dtype=torch.float32)
    pos = torch.as_tensor(np.stack([c["positions"] for c in clips]),
                          dtype=torch.float32)
    if not batched:
        rot, pos = rot[0], pos[0]
    got = tpre.featurize_clip(rot, pos, c0["order"], c0["names"],
                              c0["parents"], mirror=True,
                              contact_velocity_threshold=0.2)
    for i, clip in enumerate(clips if batched else clips[:1]):
        want = jpre.featurize_clip_jit(clip, mirror=True,
                                       contact_velocity_threshold=0.2)
        for k in tpre.ARRAY_KEYS:
            g = got[k][i] if batched else got[k]
            if k == "contacts":
                np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                           atol=FEAT_TOL, rtol=0, err_msg=k)
        unmirrored = jpre.featurize_clip_jit(clip, mirror=False)
        assert np.abs(np.asarray(unmirrored["positions"])
                      - np.asarray(want["positions"])).max() > 0.01


@pytest.mark.parametrize("T,target", [(5, 5), (5, 3), (5, 12), (4, 13),
                                      (3, 20), (1, 6), (12, 16)])
def test_reflect_pad_to_exact(T, target):
    x = np.random.RandomState(T * 31 + target).randn(T, 2, 3)
    got = twin.reflect_pad_to(x, target)
    want = jwin.reflect_pad_to(x, target)
    np.testing.assert_array_equal(got, want)
    assert len(got) == max(T, target)


@pytest.mark.parametrize("T", [7, 12, 41])
def test_whole_clip_padded_exact(T):
    clip = make_mocha_bvh_data(T=45, seed=80)
    feats = tpre.featurize_clip(
        torch.as_tensor(clip["rotations"], dtype=torch.float32),
        torch.as_tensor(clip["positions"], dtype=torch.float32),
        clip["order"], clip["names"], clip["parents"])
    feats = {k: (v[:T] if isinstance(v, torch.Tensor) else v)
             for k, v in feats.items()}
    got = twin.whole_clip_padded(feats)
    want = jwin.whole_clip_padded(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in feats.items()})
    assert set(got) == set(want)
    for k in tpre.ARRAY_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert len(got["positions"]) == max(T // 4 * 4 + 4, 12)
    assert got["bone_names"] == feats["bone_names"]


@pytest.mark.parametrize("mirror", [False, True])
def test_featurize_long_clip_far_from_origin_matches_jax(mirror):
    """A 20 s running clip, chip_smoke's dataset-phase clip 1 (root 30 m out
    by its end): positions within 2e-4, and velocities within chip_smoke's
    bar, 2e-4 plus the gap the positions' own gap implies through the
    central difference, with what the positions do not explain within
    2e-4."""
    sys.path.insert(0, REPO)
    import chip_smoke

    T = 1200
    clip = make_mocha_bvh_data(T=T, seed=3001, walk_speed=152.0)
    got = tpre.featurize_clip(
        torch.as_tensor(clip["rotations"], dtype=torch.float32),
        torch.as_tensor(clip["positions"], dtype=torch.float32),
        clip["order"], clip["names"], clip["parents"], mirror=mirror,
        contact_velocity_threshold=0.5)
    want = jpre.featurize_clip_jit(clip, mirror=mirror,
                                   contact_velocity_threshold=0.5)
    g = {"bone_positions": got["positions"].numpy(),
         "bone_velocities": got["velocities"].numpy()}
    w = {"bone_positions": np.asarray(want["positions"]),
         "bone_velocities": np.asarray(want["velocities"]),
         "range_starts": np.array([0]), "range_stops": np.array([T])}
    assert np.abs(w["bone_positions"][:, 0]).max() > 29.0
    np.testing.assert_allclose(g["bone_positions"], w["bone_positions"],
                               atol=FEAT_TOL, rtol=0)
    errs, ok = chip_smoke.velocity_parity(g, w)
    assert ok, errs
    for k in ("rotations", "angular_velocities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=FEAT_TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["contacts"].numpy(),
                                  np.asarray(want["contacts"]))
    print(f"mirror={mirror}: positions "
          f"{np.abs(g['bone_positions'] - w['bone_positions']).max():.3e}, "
          f"velocities {json.dumps(errs)}")
