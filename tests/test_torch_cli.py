"""The port's runtime additions and its characterize CLI against JAX.

Small widths (as tests/test_torch_stream.py), deterministic CVAE.  The
ragged featurizer, ``characterize_clip`` and ``compute_cm=False`` are held
to the JAX package's functions; ``runner.chunked`` to the monolithic
runner; the whole CLI (``--src`` and ``--src-dir``) to the JAX CLI, both
reading the same reference ``.pt`` files.  The JAX CLI runs in a
subprocess, because it switches on jax_enable_x64 for its whole process;
function-level JAX calls use float32 root carries.  Positions are held to
1e-3 (PARITY.md:87) and NN picks must be identical.  Written BVH
rotations are held to 1e-3 degrees, except in the ``Ours_`` files: the
IK-adjusted hips take their angle through float32 arccos, which puts them
up to 0.013 degrees apart (0.05 allowed); the other joints agree within
2e-5 degrees.  The JAX CLI subprocesses (one per source) start with the
module's fixture and run while the function-level tests run.
"""

import os
import subprocess
import sys

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
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.runtime import features as jfeat  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize as tcli  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as tfeat  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream as tstream  # noqa: E402

from test_torch_convert import save_reference_checkpoints  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
CVAE_SMALL = dict(latent_dim=32, depth=1, nheads=2, feedforward_dim=64)
FEAT_TOL = 2e-4
POS_TOL = 1e-3
DEG_TOL = 1e-3
IK_DEG_TOL = 5e-2
POS_KEYS = ("src_pos", "trans_pos", "ik_pos", "cm_pos")
ROT_KEYS = ("src_rot", "trans_rot", "ik_rot", "cm_rot")
# raw clip lengths: three groups, given out of order
LENGTHS = (100, 115, 100, 130)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _config_text():
    model = "\n".join(f"  {k}: {v}" for k, v in SMALL.items())
    cvae = "\n".join(f"  {k}: {v}" for k, v in CVAE_SMALL.items())
    return (f"model:\n{model}\ncvae:\n{cvae}\n"
            "runtime:\n  window: 60\n  contact_bones: [5, 24]\n"
            "  dt: 0.016666666666666666\n  ik: {enabled: true}\n")


def _cli_args(d, gen_path, cvae_path, out, *source):
    return ["--config", str(d / "config.yaml"), *source,
            "--cha", str(d / "cha.bvh"), "--gen-ckpt", gen_path,
            "--cvae-ckpt", cvae_path, "--out", str(out), "--deterministic"]


def _sources(d):
    return {"src": ["--src", str(d / "src" / "clip_1.bvh")],
            "dir": ["--src-dir", str(d / "src")]}


def _start_jax_cli(d, gen_path, cvae_path, key):
    """The JAX CLI in a subprocess, on the ``key`` source; its output goes
    to files next to the run's directory."""
    args = _cli_args(d, gen_path, cvae_path, d / f"jax_{key}",
                     *_sources(d)[key])
    code = ("import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from mocha_sigasia2023_tpu.cli import characterize as c\n"
            f"c.main({args!r})\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MOCHA_COMPILATION_CACHE=str(d / f"jax_cache_{key}"))
    with open(d / f"jax_{key}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], cwd=str(d),
                                env=env, stdout=log, stderr=log)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory, request):
    d = tmp_path_factory.mktemp("torch_cli")
    jcfg = jgen.GeneratorConfig(**SMALL)
    jccfg = jcvae.CVAEConfig(**CVAE_SMALL)
    params = jgen.init_generator(jax.random.PRNGKey(31), jcfg)
    cparams = jcvae.init_cvae(jax.random.PRNGKey(32), jccfg)
    gen_path, cvae_path = save_reference_checkpoints(d, _np(params),
                                                     _np(cparams))
    tg = convert.load_reference_generator_checkpoint(
        gen_path, tgen.GeneratorConfig(**SMALL), device="cpu")
    tc = convert.cvae_from_torch(convert.load_torch_file(cvae_path),
                                 tcvae.CVAEConfig(**CVAE_SMALL), device="cpu")

    cha = make_mocha_bvh_data(T=140, seed=10_000, walk_speed=60.0)
    clips = [make_mocha_bvh_data(T=L, seed=40 + i)
             for i, L in enumerate(LENGTHS)]
    (d / "src").mkdir()
    for i, c in enumerate(clips):
        tbvh.save(str(d / "src" / f"clip_{i}.bvh"), c)
    tbvh.save(str(d / "cha.bvh"), cha)
    (d / "config.yaml").write_text(_config_text())
    procs = {key: _start_jax_cli(d, gen_path, cvae_path, key)
             for key in ("src", "dir")}
    for p in procs.values():
        request.addfinalizer(p.kill)

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
    consts_j = jbuild_consts(
        norm, jfeat.compute_cnt_norm(cha_j["encoded"], cha_j["cnt"]), None,
        cha_j)
    consts_t = tstream.build_consts(
        norm, jfeat.compute_cnt_norm(cha_j["encoded"], cha_j["cnt"]), None,
        cha_j, device="cpu")
    return dict(dir=d, procs=procs, gen_path=gen_path, cvae_path=cvae_path,
                jcfg=jcfg, jccfg=jccfg, params=params, cparams=cparams, tg=tg, tc=tc,
                cha=cha, clips=clips, norm=norm, cha_j=cha_j,
                consts_j=consts_j, consts_t=consts_t,
                parents=cha_j["bone_parents"])


def _check_outputs(out_t, out_j, keys=POS_KEYS + ROT_KEYS):
    picks_t = np.asarray(out_t["nn_index"])
    picks_j = np.asarray(out_j["nn_index"])
    np.testing.assert_array_equal(picks_t, picks_j)
    for k in keys:
        a, b = np.asarray(out_t[k]), np.asarray(out_j[k])
        assert a.shape == b.shape, k
        err = np.abs(a - b).max()
        assert err <= POS_TOL, (k, err)


def test_batch_stream_features_ragged_matches_jax(pipe):
    f0_t, xs_t, nw_t, ng_t = tfeat.batch_stream_features_ragged(
        pipe["clips"], pipe["tg"], pipe["norm"], device="cpu")
    f0_j, xs_j, nw_j, ng_j = jfeat.batch_stream_features_ragged(
        pipe["clips"], pipe["params"], pipe["jcfg"], pipe["norm"])
    assert ng_t == ng_j == 3
    assert nw_t == nw_j
    assert len(set(nw_t)) == 3
    assert set(f0_t) == set(f0_j) and set(xs_t) == set(xs_j)
    for k in f0_j:
        np.testing.assert_allclose(f0_t[k].numpy(), np.asarray(f0_j[k]),
                                   atol=FEAT_TOL, rtol=0, err_msg=k)
        assert xs_t[k].shape == tuple(xs_j[k].shape), k
        np.testing.assert_allclose(xs_t[k].numpy(), np.asarray(xs_j[k]),
                                   atol=FEAT_TOL, rtol=0, err_msg=k)
    # the padded tail of a short clip repeats its last row
    short = int(np.argmin(nw_t))
    tail = xs_t["encoded"][nw_t[short] - 2:, short]
    assert torch.equal(tail, tail[:1].expand_as(tail))


def test_characterize_clip_matches_jax(pipe):
    clip = pipe["clips"][1]
    feats_t = tfeat.clip_stream_features_device(clip, pipe["tg"],
                                                pipe["norm"], device="cpu")
    out_t = tstream.characterize_clip(
        pipe["tg"], pipe["tc"], pipe["consts_t"], pipe["parents"], feats_t,
        deterministic=True, device="cpu")
    feats_j = jfeat.clip_stream_features_device(clip, pipe["params"],
                                                pipe["jcfg"], pipe["norm"])
    out_j = jstream.characterize_clip(
        pipe["params"], pipe["jcfg"], pipe["cparams"], pipe["jccfg"],
        pipe["consts_j"], pipe["parents"], feats_j, deterministic=True,
        root_dtype=jnp.float32)
    assert isinstance(out_t["ik_pos"], np.ndarray)
    assert out_t["ik_pos"].shape == (len(feats_t["encoded"]), 25, 3)
    _check_outputs(out_t, out_j)


def _jax_inputs(pipe, n=40):
    frame0, xs = jfeat.batch_stream_features_device(
        pipe["clips"][:1] + pipe["clips"][2:3], pipe["params"],
        pipe["jcfg"], pipe["norm"])
    xs = {k: v[:n] for k, v in xs.items()}
    return _np(frame0), _np(xs)


def test_compute_cm_false_matches_jax(pipe):
    frame0, xs = _jax_inputs(pipe)
    runner_t = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], pipe["consts_t"], pipe["parents"],
        deterministic=True, compute_cm=False, device="cpu")
    out_t = runner_t({k: torch.as_tensor(v) for k, v in frame0.items()},
                     {k: torch.as_tensor(v) for k, v in xs.items()})
    runner_j = jstream.make_batch_runner(
        pipe["params"], pipe["jcfg"], pipe["cparams"], pipe["jccfg"],
        pipe["consts_j"], pipe["parents"], deterministic=True,
        compute_cm=False)
    out_j = _np(runner_j(frame0, xs, jax.random.split(
        jax.random.PRNGKey(7), 2)))
    _check_outputs({k: v.numpy() for k, v in out_t.items()}, out_j)
    # the CM stream is the CVAE stream's pose before the blend
    assert torch.equal(out_t["cm_rot"], out_t["trans_rot"])


@pytest.mark.parametrize("deterministic", [True, False])
def test_chunked_runner_equals_monolithic(pipe, deterministic):
    frame0, xs = _jax_inputs(pipe, n=41)   # 41 = 2 x 16 + a trimmed 9
    runner = tstream.make_batch_runner(
        pipe["tg"], pipe["tc"], pipe["consts_t"], pipe["parents"],
        deterministic=deterministic, root_dtype=torch.float64, device="cpu")
    mono = runner({k: torch.as_tensor(v) for k, v in frame0.items()},
                  {k: torch.as_tensor(v) for k, v in xs.items()},
                  torch.Generator().manual_seed(5))
    chunked = runner.chunked(frame0, xs, torch.Generator().manual_seed(5),
                             tchunk=16)
    assert set(mono) == set(chunked)
    for k in mono:
        assert chunked[k].shape == mono[k].shape == (42,) + mono[k].shape[1:]
        np.testing.assert_allclose(chunked[k].double().numpy(),
                                   mono[k].double().numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="tchunk"):
        runner.chunked(frame0, xs, torch.Generator(), tchunk=0)


# ---------------------------------------------------------------------------
# the whole CLI
# ---------------------------------------------------------------------------


def _port_args(pipe, out, *source):
    return _cli_args(pipe["dir"], pipe["gen_path"], pipe["cvae_path"], out,
                     *source) + ["--device", "cpu"]


@pytest.fixture(scope="module")
def cli_runs(pipe):
    """The port's CLI on the CPU and the JAX CLI's finished subprocesses, on
    the same files."""
    d = pipe["dir"]
    for key, source in _sources(d).items():
        tcli.main(_port_args(pipe, d / f"torch_{key}", *source))
    for key, proc in pipe["procs"].items():
        rc = proc.wait(timeout=300)
        assert rc == 0, (d / f"jax_{key}.log").read_text()[-4000:]
    return d


def _compare_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    frames = []
    for f in names:
        got = tbvh.load(os.path.join(a, f))
        want = tbvh.load(os.path.join(b, f))
        assert got["names"] == want["names"], f
        np.testing.assert_array_equal(got["parents"], want["parents"])
        assert got["rotations"].shape == want["rotations"].shape, f
        np.testing.assert_allclose(got["positions"], want["positions"],
                                   atol=POS_TOL, rtol=0, err_msg=f)
        np.testing.assert_allclose(
            got["rotations"], want["rotations"], rtol=0, err_msg=f,
            atol=IK_DEG_TOL if f.startswith("Ours_") else DEG_TOL)
        frames.append(len(got["rotations"]))
    return names, frames


def test_cli_single_clip_matches_jax(cli_runs):
    names, frames = _compare_dirs(cli_runs / "torch_src",
                                  cli_runs / "jax_src")
    assert names == ["CM_clip_1_To_cha.bvh", "Ours_clip_1_To_cha.bvh",
                     "Src_clip_1.bvh"]
    assert len(set(frames)) == 1


def test_cli_src_dir_matches_jax(cli_runs):
    names, frames = _compare_dirs(cli_runs / "torch_dir",
                                  cli_runs / "jax_dir")
    assert len(names) == 3 * len(LENGTHS)
    per_clip = {n.split("clip_")[1][0]: f for n, f in zip(names, frames)}
    # every clip trimmed to its own length; lengths differ
    assert len(set(per_clip.values())) == 3
    assert per_clip["0"] == per_clip["2"]


def test_cli_tchunk_equals_monolithic(pipe, cli_runs):
    out = cli_runs / "torch_tchunk"
    tcli.main(_port_args(pipe, out, "--src-dir", str(cli_runs / "src"))
              + ["--tchunk", "16"])
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(cli_runs / "torch_dir"))
    for f in names:
        a = tbvh.load(str(out / f))
        b = tbvh.load(str(cli_runs / "torch_dir" / f))
        np.testing.assert_allclose(a["rotations"], b["rotations"],
                                   atol=1e-4, err_msg=f)
        np.testing.assert_allclose(a["positions"], b["positions"],
                                   atol=1e-4, err_msg=f)


def test_cli_production_writes_cm_from_the_cvae_stream(pipe, tmp_path):
    d = pipe["dir"]
    out = tcli.main(_port_args(pipe, tmp_path, "--src",
                               str(d / "src" / "clip_0.bvh"))
                    + ["--production", "--no-ik"])
    np.testing.assert_array_equal(out["cm_rot"], out["trans_rot"])
    np.testing.assert_array_equal(out["ik_rot"], out["trans_rot"])
    assert len(os.listdir(tmp_path)) == 3


def test_cli_refuses_bad_arguments(pipe, tmp_path):
    d = pipe["dir"]
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    tbvh.save(str(mixed / "a.bvh"), pipe["clips"][0])
    other = dict(pipe["clips"][1])
    other["names"] = ["X" + n for n in other["names"]]
    tbvh.save(str(mixed / "b.bvh"), other)
    with pytest.raises(SystemExit, match="skeleton differs"):
        tcli.main(_port_args(pipe, tmp_path / "o", "--src-dir", str(mixed)))
    with pytest.raises(SystemExit, match="R8"):
        tcli.main(["--config", str(d / "config.yaml"), "--src",
                   str(d / "src" / "clip_0.bvh"), "--cha", str(d / "cha.bvh"),
                   "--gen-ckpt", "gen_001.msgpack", "--device", "cpu"])
    with pytest.raises(SystemExit):   # --tchunk needs --src-dir
        tcli.main(_port_args(pipe, tmp_path / "o", "--src",
                             str(d / "src" / "clip_0.bvh")) + ["--tchunk", "8"])
