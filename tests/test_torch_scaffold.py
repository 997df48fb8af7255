"""The PyTorch port's package boundary, graph tables and numerics guards.

The port (mocha_sigasia2023_torch) must import neither JAX nor anything of
the JAX package; its graph tables and safe_sqrt must equal the JAX
package's; its entry points default to CUDA and refuse to fall back.
"""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import graph as jgraph  # noqa: E402
from mocha_sigasia2023_tpu.ops import numerics as jnum  # noqa: E402

import mocha_sigasia2023_torch  # noqa: E402
from mocha_sigasia2023_torch.models import graph as tgraph  # noqa: E402
from mocha_sigasia2023_torch.ops import numerics as tnum  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "mocha_sigasia2023_torch")


def _port_modules():
    return ["mocha_sigasia2023_torch"] + [
        m.name for m in pkgutil.walk_packages(
            [PORT_DIR], prefix="mocha_sigasia2023_torch.")]


def test_import_loads_no_jax():
    mods = _port_modules()
    for m in ("runtime.stream", "runtime.export", "runtime.live",
              "runtime.matching", "cli.characterize", "io.bvh",
              "utils.config", "cli.generate_database",
              "cli.collect_features", "io.database", "cli.train",
              "train.trainer", "train.losses", "train.checkpoint",
              "kinematics.xform", "models.projector", "utils.logging",
              "train.trainer_cvae", "cli.train_cvae", "io.msgpack",
              "cli.convert_checkpoint"):
        assert "mocha_sigasia2023_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'msgpack', 'yaml', "
        "'mocha_sigasia2023_tpu')]\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT_DIR):
        dirs[:] = [d for d in dirs if d != "_build"]   # build output
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for sub in ("cli", "io", "utils"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for name in ("live.py", "matching.py", "generate_database.py",
                 "collect_features.py", "database.py"):
        assert any(f.endswith(os.sep + name) for f in files), name
    # chip_smoke.py drives the general kernel and the dataset path too
    smoke = open(files[0]).read()
    for phase in ('"kernels (general)", general_phase',
                  '"dataset", dataset_phase', '"train", train_phase',
                  '"cvae", cvae_phase'):
        assert phase in smoke, phase
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                               "yaml", "mocha_sigasia2023_tpu"), (path, name)
        # nor does it join the JAX package's directory into a path
        assert not re.search(r"""['"]mocha_sigasia2023_tpu['"]""",
                             open(path).read()), path


@pytest.mark.parametrize("layout", sorted(jgraph.JOINT_PARENTS))
@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
def test_joint_adjacency_equal(layout, strategy):
    np.testing.assert_array_equal(
        tgraph.joint_adjacency(layout, strategy, 2),
        jgraph.joint_adjacency(layout, strategy, 2))


@pytest.mark.parametrize("layout", sorted(jgraph.BODYPART_PARTITIONS))
def test_bodypart_and_pool_tables_equal(layout):
    for strategy in ("uniform", "distance", "spatial"):
        np.testing.assert_array_equal(
            tgraph.bodypart_adjacency(layout, strategy, 1),
            jgraph.bodypart_adjacency(layout, strategy, 1))
    np.testing.assert_array_equal(tgraph.pool_matrix(layout),
                                  jgraph.pool_matrix(layout))
    np.testing.assert_array_equal(tgraph.unpool_matrix(layout),
                                  jgraph.unpool_matrix(layout))


def test_safe_sqrt_and_unit_denom_match_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(64) * 10, [0.0, 1e-30, 1e-24, 1e-20]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(
        tnum.safe_sqrt(torch.as_tensor(x)).numpy(),
        np.asarray(jnum.safe_sqrt(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tnum.safe_sqrt(torch.as_tensor(x), 1e-30).numpy(),
        np.asarray(jnum.safe_sqrt(jnp.asarray(x), 1e-30)))
    c = rng.randn(16, 3).astype(np.float32)
    c[0] = 0.0
    c[1] = 1e-8
    np.testing.assert_allclose(
        tnum.safe_unit_denom(torch.as_tensor(c)).numpy(),
        np.asarray(jnum.safe_unit_denom(jnp.asarray(c))), rtol=1e-6)


def test_entry_points_default_to_cuda(tmp_path):
    from mocha_sigasia2023_torch.cli import characterize
    from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
    from mocha_sigasia2023_torch.device import resolve_device
    from mocha_sigasia2023_torch.io import bvh
    from mocha_sigasia2023_torch.models.generator import (
        GeneratorConfig, init_generator)
    from mocha_sigasia2023_torch.runtime import features, live, stream

    assert mocha_sigasia2023_torch.__version__
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_generator(GeneratorConfig(encoder_dim=32, decoder_dim=32))
    small = GeneratorConfig(encoder_dim=32, decoder_dim=32)
    gen = init_generator(small, device="cpu")
    clip = make_mocha_bvh_data(T=80, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.batch_stream_features_ragged([clip], gen, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.characterize_clip(gen, None, None, None, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live.LiveCharacterizer(gen, None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.make_batch_runner(gen, None, None, None,
                                 multi_character=True)
    from mocha_sigasia2023_torch.cli import train
    from mocha_sigasia2023_torch.train.trainer import GeneratorTrainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeneratorTrainer({}, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([])
    bvh.save(str(tmp_path / "c.bvh"), clip)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        characterize.main(["--src", str(tmp_path / "c.bvh"), "--cha",
                           str(tmp_path / "c.bvh"), "--random-init",
                           "--out", str(out)])
    assert not out.exists()   # nothing ran on the CPU
