"""The port's reader of the JAX package's msgpack checkpoints, its
convert_checkpoint and train_cvae CLIs, and characterize on both formats.

The chain is made here, small (the widths of tests/test_cli.py): two
synthetic BVH clips (AverageJoe and Princess walking), the database, the
JAX ``MotionDataset``'s norm.npz; ``gen_001.msgpack`` written by the JAX
``GeneratorTrainer.save`` (the writer ``cli/train`` calls; its EMA drawn
apart from its weights so that serving the wrong branch shows, and no
epoch run, which would cost the JAX step's compile); the JAX
``collect_features`` cnt-norm and character exports on it; and the JAX
``train_cvae`` CLI for 3 iterations, which writes ``cvae_000003.msgpack``
and ``cvae_norm.npz``.  The JAX characterize CLI runs in a subprocess (it
switches on jax_enable_x64 for its process) on those files.

Bars: the reader's leaves bit for bit against flax's ``msgpack_restore``;
characterize on the msgpack files against the JAX CLI at
tests/test_torch_cli.py's bars (positions 1e-3, angles 1e-3 degrees, 5e-2
in the IK-adjusted ``Ours_`` files); converted ``.ckpt`` files serve the
same frames exactly; the port's train_cvae writes a ``cvae_norm.npz``
equal to JAX's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from mocha_sigasia2023_tpu.cli import collect_features as jcf  # noqa: E402
from mocha_sigasia2023_tpu.cli import train_cvae as jtrain_cvae  # noqa: E402
from mocha_sigasia2023_tpu.data import dataset as jds  # noqa: E402
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.parallel import make_mesh  # noqa: E402
from mocha_sigasia2023_tpu.train import checkpoint as jckpt  # noqa: E402
from mocha_sigasia2023_tpu.train import trainer as jtrainer  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize as tchar  # noqa: E402
from mocha_sigasia2023_torch.cli import convert_checkpoint  # noqa: E402
from mocha_sigasia2023_torch.cli import generate_database as tgd  # noqa: E402
from mocha_sigasia2023_torch.cli import train_cvae as ttrain_cvae  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.io import msgpack as tmsgpack  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.train import checkpoint as tckpt  # noqa: E402

from test_torch_cli import _compare_dirs  # noqa: E402
from test_torch_convert import save_reference_checkpoints  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENTS = [-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13, 14, 8, 16, 17,
           18, 0, 20, 21, 22]
MODEL = {
    "mot_in_dim": 15, "nframes": 60, "njoints": 24, "nbody": 6,
    "temporal_patch_size": 4,
    "encoder_dim": 32, "encoder_depth": 1, "encoder_heads": 2,
    "encoder_dim_head": 16, "encoder_mlp_dim": 64,
    "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2,
    "decoder_dim_head": 16, "decoder_mlp_dim": 64,
    "prj_dim": 32, "num_patches": -1,
    "graph": {
        "joint": {"layout": "mocha", "strategy": "distance", "max_hop": 2},
        "bodypart": {"layout": "mocha", "strategy": "distance",
                     "max_hop": 1},
    },
}
CONFIG = {
    "name": "model_tiny", "dataset": {"mocha": {"parents": PARENTS}},
    "model": MODEL, "manualSeed": 1777, "max_epochs": 1, "batch_size": 4,
    "lr_gen": 1e-4, "weight_decay_gen": 1e-4, "lr_drop": 100,
    "rec_w": 1, "nce_w": 0.1, "cyc_w": 1, "log_every": 1,
    "cvae": {"latent_dim": 32, "depth": 1, "nheads": 2,
             "feedforward_dim": 64, "rollout_steps": 4, "batch_size": 4},
    "runtime": {"window": 60, "contact_bones": [5, 24], "dt": 1.0 / 60.0,
                "ik": {"enabled": True}},
}
SRC, CHA = "Walk_Neutral_AverageJoe_001", "Walk_Neutral_Princess_002"
CVAE_ITERS = 3


def _char_args(d, gen, cvae, cvae_norm, out):
    return ["--config", str(d / "config.yaml"),
            "--src", str(d / "bvh" / f"{SRC}.bvh"),
            "--cha", str(d / "bvh" / f"{CHA}.bvh"),
            "--gen-ckpt", str(gen), "--cvae-ckpt", str(cvae),
            "--cvae-norm", str(cvae_norm),
            "--norm", str(d / "data" / "norm.npz"),
            "--cnt-norm", str(d / "data" / "cnt_norm.npz"),
            "--out", str(out), "--deterministic"]


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


@pytest.fixture(scope="module")
def chain(tmp_path_factory, request):
    d = tmp_path_factory.mktemp("msgpack_chain")
    (d / "bvh").mkdir()
    tbvh.save(str(d / "bvh" / f"{SRC}.bvh"), make_mocha_bvh_data(T=180,
                                                                seed=1))
    tbvh.save(str(d / "bvh" / f"{CHA}.bvh"),
              make_mocha_bvh_data(T=200, seed=2, walk_speed=60.0))
    (d / "config.yaml").write_text(yaml.safe_dump(CONFIG))
    data = d / "data"
    tgd.main(["--bvh-dir", str(d / "bvh"), "--out", str(data), "--device",
              "cpu"])
    cfg = dict(CONFIG, data_dir=str(data))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOCHA_COMPILATION_CACHE", str(d / "jax_cache"))
        mp.chdir(d)
        jds.MotionDataset(str(data))
        jt = jtrainer.GeneratorTrainer(cfg, steps_per_epoch=10,
                                       mesh=make_mesh(n_data=1))
        jt.state = jt.state._replace(gen_ema=jgen.init_generator(
            jax.random.PRNGKey(5), jgen.GeneratorConfig.from_dict(MODEL)))
        (d / "pth").mkdir()
        gen = jt.save(str(d / "pth"), 1)
        common = ["--config", str(d / "config.yaml"), "--data-dir",
                  str(data), "--gen-ckpt", gen]
        jcf.main(["cnt-norm", *common])
        for style, name in (("2", "src"), ("17", "cha")):
            jcf.main(["character", *common, "--styles", style, "--actions",
                      "7", "--out", str(d / f"{name}_feature.npz")])
        jtrain_cvae.main(_cvae_args(d, d / "jax_cvae"))
    cvae = d / "jax_cvae" / f"cvae_{CVAE_ITERS:06d}.msgpack"
    proc = _start_jax_characterize(d, _char_args(
        d, gen, cvae, d / "jax_cvae" / "cvae_norm.npz", d / "jax_out"))
    request.addfinalizer(proc.kill)
    return dict(dir=d, gen=gen, cvae=str(cvae), proc=proc,
                gen_cfg=tgen.GeneratorConfig.from_dict(MODEL),
                cvae_cfg=tcvae.CVAEConfig(output_seq=90, latent_dim=32,
                                          depth=1, nheads=2,
                                          feedforward_dim=64))


def _cvae_args(d, out):
    return ["--config", str(d / "config.yaml"),
            "--src-features", str(d / "src_feature.npz"),
            "--cha-features", str(d / "cha_feature.npz"),
            "--cnt-norm", str(d / "data" / "cnt_norm.npz"),
            "--out", str(out), "--num-iters", str(CVAE_ITERS),
            "--batch-size", "4"]


def _leaves(tree, prefix=""):
    """{dotted path: leaf}; dicts with keys "0".."n-1" and lists give the
    same paths."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _same_leaf(got, want, path):
    if isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), path)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
        return
    assert type(got) is type(want) and got == want, (path, got, want)


def _same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in w:
        _same_leaf(g[path], w[path], path)
    return w


def test_reader_reads_the_generator_checkpoint_bit_for_bit(chain):
    """gen, gen_ema, prj and optax's opt_state (empty states, NamedTuples
    as index maps, the int32 step count), every leaf's bytes."""
    got = tmsgpack.read_msgpack(chain["gen"])
    want = jckpt.load_checkpoint(chain["gen"])
    assert sorted(got) == ["gen", "gen_ema", "opt_state", "prj"]
    leaves = _same_tree(got, want)
    assert any(p.startswith("opt_state") and p.endswith("count")
               for p in leaves)
    assert isinstance(got["gen"]["encoder"]["layers"], list)
    assert isinstance(got["opt_state"], list)


def test_reader_reads_bf16_scalar_complex_and_chunked_leaves(tmp_path,
                                                             monkeypatch):
    """A {"cvae": ...} file with a bf16 leaf and NumPy scalars through the
    JAX save_checkpoint (which makes scalars 0-d arrays), then flax's
    serializer alone: a NumPy scalar (ext 3), a complex (ext 2) and an
    array split into chunks."""
    params = jcvae.init_cvae(jax.random.PRNGKey(0), jcvae.CVAEConfig(
        output_seq=12, latent_dim=16, depth=1, nheads=2, feedforward_dim=32))
    path = str(tmp_path / "cvae_000003.msgpack")
    jckpt.save_checkpoint(path, {
        "cvae": params,
        "bf16": (jnp.arange(12, dtype=jnp.float32) / 7).astype(
            jnp.bfloat16).reshape(3, 4),
        "scalar": np.float32(2.5), "step": np.int64(7)})
    got = tmsgpack.read_msgpack(path)
    _same_tree(got, jckpt.load_checkpoint(path))
    assert got["bf16"].dtype == torch.bfloat16
    cvae = convert.cvae_from_jax(got["cvae"], tcvae.CVAEConfig(
        output_seq=12, latent_dim=16, depth=1, nheads=2, feedforward_dim=32),
        device="cpu")
    assert torch.equal(cvae.prior.mu_token,
                       torch.as_tensor(np.array(params["prior"]["mu_token"])))

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1 << 12)
    tree = {"scalar": np.float32(1.25), "int": np.int16(-3),
            "bf16_scalar": jnp.bfloat16(0.5), "complex": complex(1.5, -2.0),
            "chunked": np.arange(5000, dtype=np.float64).reshape(50, 100),
            "list": [np.ones(2, np.int8), [True, None, "name", b"\x00\x01"],
                     -40, 1 << 40, 0.1]}
    data = serialization.msgpack_serialize(tree)
    got = tmsgpack.unpack(data)
    want = serialization.msgpack_restore(data)
    assert type(got["scalar"]) is np.float32 and got["scalar"] == 1.25
    assert type(got["int"]) is np.int16 and got["int"] == -3
    assert got["bf16_scalar"].dtype == torch.bfloat16 and \
        got["bf16_scalar"].item() == 0.5
    assert got["complex"] == complex(1.5, -2.0)
    np.testing.assert_array_equal(got["chunked"], want["chunked"])
    assert got["list"][1] == [True, None, "name", b"\x00\x01"]
    assert got["list"][2:] == [-40, 1 << 40, 0.1]
    _same_tree({k: v for k, v in got.items() if k != "bf16_scalar"},
               {k: v for k, v in want.items() if k != "bf16_scalar"})


def test_reader_raises_on_cut_files_and_unknown_bytes(chain):
    data = open(chain["gen"], "rb").read()
    for cut in (0, 1, 7, len(data) // 3, len(data) - 1):
        with pytest.raises(ValueError, match="truncated.* at offset"):
            tmsgpack.unpack(data[:cut])
    with pytest.raises(ValueError, match="trailing bytes at offset"):
        tmsgpack.unpack(data + b"\x00")
    with pytest.raises(ValueError, match="unknown type byte 0xc1 at offset 0"):
        tmsgpack.unpack(b"\xc1")
    # a one-entry map whose value's type byte is unknown
    with pytest.raises(ValueError, match="unknown type byte 0xc1 at "
                                         "offset 3"):
        tmsgpack.unpack(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="unknown ext type 9 at offset 1"):
        tmsgpack.unpack(b"\xd4\x09\x00")
    bad = serialization.msgpack_serialize({"x": np.zeros(2, np.float32)})
    with pytest.raises(ValueError,
                       match="8 bytes for a float64 array of shape"):
        tmsgpack.unpack(bad.replace(b"float32", b"float64"))


def test_reader_imports_neither_msgpack_nor_flax(chain):
    """In a fresh process: reading a JAX checkpoint and building the port's
    modules from it loads no msgpack, flax, optax or JAX module."""
    code = ("import sys\n"
            "from mocha_sigasia2023_torch.io.msgpack import read_msgpack\n"
            "from mocha_sigasia2023_torch.cli import convert_checkpoint\n"
            "from mocha_sigasia2023_torch.cli import characterize\n"
            f"tree = read_msgpack({chain['gen']!r})\n"
            "assert 'gen_ema' in tree\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('msgpack', 'flax', 'optax', 'jax', 'jaxlib', "
            "'mocha_sigasia2023_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def port_msgpack_run(chain):
    d = chain["dir"]
    tchar.main(_char_args(d, chain["gen"], chain["cvae"],
                          d / "jax_cvae" / "cvae_norm.npz", d / "port_out")
               + ["--device", "cpu"])
    return d / "port_out"


def test_characterize_on_jax_msgpack_matches_jax_cli(chain,
                                                     port_msgpack_run):
    d = chain["dir"]
    rc = chain["proc"].wait(timeout=600)
    assert rc == 0, (d / "jax_char.log").read_text()[-4000:]
    names, frames = _compare_dirs(port_msgpack_run, d / "jax_out")
    assert len(names) == 3 and frames == [180 - 15] * 3


def test_characterize_serves_the_msgpack_ema(chain):
    """The served generator is the file's gen_ema, not its gen."""
    tree = tmsgpack.read_msgpack(chain["gen"])
    args = tchar.build_parser().parse_args(
        ["--cha", "x.bvh", "--gen-ckpt", chain["gen"]])
    served = tchar.load_generator(args, chain["gen_cfg"], torch.device("cpu"))
    ema = convert.generator_from_jax(tree["gen_ema"], chain["gen_cfg"],
                                     device="cpu")
    raw = convert.generator_from_jax(tree["gen"], chain["gen_cfg"],
                                     device="cpu")
    for (k, a), b, c in zip(served.state_dict().items(),
                            ema.state_dict().values(),
                            raw.state_dict().values()):
        assert torch.equal(a, b), k
    assert not all(torch.equal(a, c) for a, c in zip(
        served.state_dict().values(), raw.state_dict().values()))


def test_convert_checkpoint_serves_the_same_frames(chain, port_msgpack_run,
                                                   tmp_path):
    d = chain["dir"]
    gen_ckpt, cvae_ckpt = tmp_path / "gen_001.ckpt", tmp_path / "cvae.ckpt"
    cfg = ["--config", str(d / "config.yaml")]
    convert_checkpoint.main([chain["gen"], str(gen_ckpt), "--kind", "gen",
                             *cfg])
    convert_checkpoint.main([chain["cvae"], str(cvae_ckpt), "--kind",
                             "cvae", *cfg])
    convert_checkpoint.main([chain["gen"], str(tmp_path / "prj.ckpt"),
                             "--kind", "projector", *cfg])
    saved = tckpt.load_checkpoint(str(gen_ckpt))
    # the JAX trainer's AdamW state comes along (trainer.load resumes it)
    assert sorted(saved) == ["gen", "gen_ema", "opt_state", "prj", "step"]
    tree = tmsgpack.read_msgpack(chain["gen"])
    adamw = saved["opt_state"]["adamw"]
    assert saved["step"] == adamw["count"] == int(
        tree["opt_state"][1][0]["count"])
    mu = convert.flatten_pytree(tree["opt_state"][1][0]["mu"]["gen"])
    for k, v in adamw["exp_avg"]["gen"].items():
        np.testing.assert_array_equal(v.numpy(), mu[k])
    flat = convert.flatten_pytree(tree["prj"])
    for k, v in tckpt.load_checkpoint(str(tmp_path / "prj.ckpt"))[
            "prj"].items():
        np.testing.assert_array_equal(v.numpy(), flat[k])
    assert tckpt.load_checkpoint(str(cvae_ckpt))["iteration"] == CVAE_ITERS
    out = tmp_path / "out"
    tchar.main(_char_args(d, gen_ckpt, cvae_ckpt,
                          d / "jax_cvae" / "cvae_norm.npz", out)
               + ["--device", "cpu"])
    names = sorted(os.listdir(port_msgpack_run))
    assert names == sorted(os.listdir(out))
    for f in names:
        a, b = tbvh.load(str(out / f)), tbvh.load(str(port_msgpack_run / f))
        np.testing.assert_array_equal(a["rotations"], b["rotations"], f)
        np.testing.assert_array_equal(a["positions"], b["positions"], f)


def test_convert_checkpoint_reads_reference_files(tmp_path):
    """The reference .pt files convert to .ckpt files holding the weights
    the existing .pt loaders give."""
    cfg = tgen.GeneratorConfig.from_dict(MODEL)
    ccfg = tcvae.CVAEConfig(output_seq=90, latent_dim=32, depth=1, nheads=2,
                            feedforward_dim=64)
    params = jax.tree.map(np.array, jgen.init_generator(
        jax.random.PRNGKey(3), jgen.GeneratorConfig.from_dict(MODEL)))
    cparams = jax.tree.map(np.array, jcvae.init_cvae(
        jax.random.PRNGKey(4), jcvae.CVAEConfig(latent_dim=32, depth=1,
                                                nheads=2, feedforward_dim=64)))
    gen_pt, cvae_pt = save_reference_checkpoints(tmp_path, params, cparams)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(CONFIG))
    cfg_args = ["--config", str(tmp_path / "config.yaml")]
    convert_checkpoint.main([gen_pt, str(tmp_path / "g.ckpt"), *cfg_args])
    convert_checkpoint.main([cvae_pt, str(tmp_path / "c.ckpt"), "--kind",
                             "cvae", *cfg_args])
    want = convert.load_reference_generator_checkpoint(gen_pt, cfg,
                                                       device="cpu")
    got = tckpt.load_checkpoint(str(tmp_path / "g.ckpt"))["gen_ema"]
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    want = convert.cvae_from_torch(convert.load_torch_file(cvae_pt), ccfg,
                                   device="cpu")
    got = tckpt.load_checkpoint(str(tmp_path / "c.ckpt"))["cvae"]
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    with pytest.raises(SystemExit, match="not a .pt or .msgpack"):
        convert_checkpoint.main([str(tmp_path / "g.ckpt"),
                                 str(tmp_path / "h.ckpt")])


def test_train_cvae_cli_writes_checkpoint_and_jax_norms(chain):
    """The port's train_cvae on the JAX chain's feature files (--device
    cpu): cvae_000003.ckpt, its metrics, a cvae_norm.npz equal to the JAX
    CLI's; then characterize --cvae-ckpt on it."""
    d = chain["dir"]
    out = d / "port_cvae"
    trainer = ttrain_cvae.main(_cvae_args(d, out) + ["--device", "cpu"])
    assert trainer.updates == CVAE_ITERS * (CONFIG["cvae"]["rollout_steps"]
                                            - 1)
    saved = tckpt.load_checkpoint(str(out / "cvae_000003.ckpt"))
    assert saved["iteration"] == CVAE_ITERS
    for k, v in trainer.cvae.state_dict().items():
        assert torch.equal(saved["cvae"][k], v), k
    got = dict(np.load(str(out / "cvae_norm.npz")))
    want = dict(np.load(str(d / "jax_cvae" / "cvae_norm.npz")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lines = (out / "log" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == CVAE_ITERS * 5       # log_every 1, 5 scalars
    res = d / "port_cvae_out"
    tchar.main(_char_args(d, chain["gen"], out / "cvae_000003.ckpt",
                          out / "cvae_norm.npz", res) + ["--device", "cpu"])
    for f in sorted(os.listdir(res)):
        bvh_out = tbvh.load(str(res / f))
        assert bvh_out["rotations"].shape[0] == 180 - 15, f
        assert np.isfinite(bvh_out["rotations"]).all(), f
        assert np.isfinite(bvh_out["positions"]).all(), f


def test_train_cvae_cli_defaults_to_cuda(chain, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cvae.main(_cvae_args(chain["dir"], tmp_path / "cvae"))
    assert not (tmp_path / "cvae").exists()
