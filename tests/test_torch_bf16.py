"""The port's decode variants and bf16 modes against the JAX package.

Small widths, deterministic CVAE, float32 roots, one character and two
source streams of 65 frames (the fixture of tests/test_torch_multi.py).

* ``decode_stream`` (the lean decoder) against JAX's within 1e-4;
  ``lean_decode`` and ``fuse_decodes`` against the default step within
  1e-4 (tests/test_runtime.py:607-643).
* The bf16 plain attention (the bf16 kernel's contract on the CPU) against
  the JAX Pallas kernel in interpret mode on bf16 inputs, within the
  kernel's tolerance (atol 8e-3 / rtol 8e-3).
* bf16 weights with ``compute_dtype`` (and ``cvae_dtype`` alone) against
  float32, on the port and on JAX, each within 2e-3 in positions with at
  least 90% identical picks, identical under ``cvae_dtype``
  (tests/test_runtime.py:806-851).  The two bf16 paths are not held
  tightly to each other: JAX's default bf16 attention is its einsum path,
  with bf16 logits and softmax (mocha_sigasia2023_tpu/models/layers.py:
  226-232), where the port's runs the kernel's arithmetic (float32 logits
  and softmax, P rounded to bf16).
* The CLI's ``--bf16`` on the CPU: every file finite, with its clip's
  frame count.
"""

import copy

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.ops import attention as jattn  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize as tcli  # noqa: E402
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.ops import attention as tattn  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream as tstream  # noqa: E402

from test_torch_cli import _config_text  # noqa: E402
from test_torch_multi import build_pipe, torch_inputs  # noqa: E402

torch.set_num_threads(2)
POS_KEYS = ("trans_pos", "ik_pos", "cm_pos")
BF16_TOL = 2e-3
ATTN_TOL = 8e-3


@pytest.fixture(scope="module")
def pipe():
    return build_pipe(n_src=2)


def _run(pipe, gen=None, cvae=None, **kw):
    runner = tstream.make_batch_runner(
        gen or pipe["tg"], cvae or pipe["tc"], pipe["consts_t"][0],
        pipe["parents"], deterministic=True, device="cpu", **kw)
    return {k: v.numpy() for k, v in runner(*torch_inputs(pipe)).items()}


@pytest.fixture(scope="module")
def f32_out(pipe):
    return _run(pipe)


def _bf16(module):
    return copy.deepcopy(module).to(torch.bfloat16)


def test_decode_stream_matches_jax_and_full_decode(pipe):
    rng = np.random.RandomState(4)
    src = rng.randn(3, 90, 32).astype(np.float32)
    cha = rng.randn(3, 90, 32).astype(np.float32)
    last_t, vel_t = tgen.decode_stream(pipe["tg"], torch.as_tensor(src),
                                       torch.as_tensor(cha))
    last_j, vel_j = jgen.decode_stream(pipe["params"], pipe["jcfg"],
                                       jnp.asarray(src), jnp.asarray(cha))
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=1e-4)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-4)
    full = tgen.decode(pipe["tg"], torch.as_tensor(src), torch.as_tensor(cha))
    np.testing.assert_allclose(last_t.numpy(), full[:, -1].numpy(), atol=1e-5)
    np.testing.assert_allclose(vel_t.numpy(), full[:, :, 0, 9:12].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("variant", [dict(lean_decode=True),
                                     dict(fuse_decodes=True),
                                     dict(lean_decode=True,
                                          fuse_decodes=True)])
def test_lean_and_fused_decodes_match_default(pipe, f32_out, variant):
    out = _run(pipe, **variant)
    np.testing.assert_array_equal(out["nn_index"], f32_out["nn_index"])
    for k in POS_KEYS:
        np.testing.assert_allclose(out[k], f32_out[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(2, 2, 17, 45, 64), (1, 4, 90, 90, 128),
                                   (1, 4, 90, 90, 256), (1, 4, 90, 45, 256)])
def test_bf16_plain_attention_matches_jax_kernel(shape):
    b, h, n, m, d = shape
    rng = np.random.RandomState(n)
    q, k, v = (rng.randn(b, h, r, d).astype(np.float32) for r in (n, m, m))
    want = jattn.fused_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)),
                                 scale=d ** -0.5, interpret=True)
    got = tattn.attention_reference(
        *(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)),
        d ** -0.5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    # the CPU wrapper takes the same plain version and counts nothing
    before = tattn.fused_attention.launches_bf16
    out = tattn.fused_attention(
        *(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)),
        scale=d ** -0.5)
    assert torch.equal(out, got)
    assert tattn.fused_attention.launches_bf16 == before


def _held_to_f32(out, ref, same_picks):
    for k in POS_KEYS:
        err = float(np.abs(out[k] - ref[k]).max())
        assert err <= BF16_TOL, f"{k}: bf16 drift {err:.2e} > {BF16_TOL}"
    same = float(np.mean(out["nn_index"] == ref["nn_index"]))
    assert same == 1.0 if same_picks else same >= 0.9, same


@pytest.mark.parametrize("mode", ["compute", "cvae"])
def test_port_bf16_tracks_f32(pipe, f32_out, mode):
    if mode == "compute":
        out = _run(pipe, gen=_bf16(pipe["tg"]), cvae=_bf16(pipe["tc"]),
                   compute_dtype=torch.bfloat16)
    else:
        out = _run(pipe, cvae=_bf16(pipe["tc"]), cvae_dtype=torch.bfloat16)
    assert all(np.isfinite(out[k]).all() for k in POS_KEYS)
    _held_to_f32(out, f32_out, same_picks=mode == "cvae")


def test_jax_bf16_tracks_f32(pipe):
    """The same bound, on the JAX package's own bf16 path."""
    def run(params, cparams, **kw):
        runner = jstream.make_batch_runner(
            params, pipe["jcfg"], cparams, pipe["jccfg"], pipe["consts_j"][0],
            pipe["parents"], deterministic=True, **kw)
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        return jax.tree.map(np.asarray, runner(pipe["frame0_j"],
                                               pipe["xs_j"], keys))

    def to16(tree):
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)

    ref = run(pipe["params"], pipe["cparams"])
    out = run(to16(pipe["params"]), to16(pipe["cparams"]),
              compute_dtype=jnp.bfloat16)
    _held_to_f32(out, ref, same_picks=False)


def test_cli_bf16_on_cpu(tmp_path):
    (tmp_path / "config.yaml").write_text(_config_text())
    src = tmp_path / "src"
    src.mkdir()
    lengths = {"a.bvh": 75, "b.bvh": 80}
    from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
    for i, (name, T) in enumerate(lengths.items()):
        tbvh.save(str(src / name), make_mocha_bvh_data(T=T, seed=40 + i))
    tbvh.save(str(tmp_path / "cha.bvh"),
              make_mocha_bvh_data(T=100, seed=50, walk_speed=60.0))
    out = tmp_path / "out"
    tcli.main(["--config", str(tmp_path / "config.yaml"), "--src-dir",
               str(src), "--cha", str(tmp_path / "cha.bvh"), "--random-init",
               "--bf16", "--device", "cpu", "--out", str(out)])
    for name, T in lengths.items():
        stem = name[:-4]
        for f in (f"Src_{name}", f"Ours_{stem}_To_cha.bvh",
                  f"CM_{stem}_To_cha.bvh"):
            d = tbvh.load(str(out / f))
            assert d["rotations"].shape[0] == T - 15, f
            assert np.isfinite(d["rotations"]).all(), f
            assert np.isfinite(d["positions"]).all(), f
