"""The port's parallel layer on the CPU: two gloo ranks, spawned once for
the module (tests/torch_parallel_ranks.module_rank), against the JAX
package's mesh on 8 virtual devices.

Held: the mesh shapes (the default over 2 ranks, ``n_data=1, n_model=2``),
``shard_batch``'s blocks, ``shard_streams``, ``replicate``, the
all-reduces and gather, ``initialize_multihost`` / ``is_primary_host``
(as tests/test_parallel.py:158-210 holds the JAX ones), and sharded
serving at tests/test_parallel.py:73-154's sizes (S = 8 streams, T = 12
frames, M = 64 database windows, dims 32, depth 1): deterministic, the 2
ranks' gathered outputs equal to the port's unsharded runner and to the
JAX package's unsharded and sharded (8 devices) runs within JAX's own
bars (atol / rtol 1e-6, rotations by quaternion dot > 1 - 1e-6); not
deterministic, equal to the unsharded port runner under the same
generator seed.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import CVAEConfig as JCVAEConfig  # noqa: E402
from mocha_sigasia2023_tpu.models import GeneratorConfig as JGenConfig  # noqa: E402
from mocha_sigasia2023_tpu.models.cvae import init_cvae  # noqa: E402
from mocha_sigasia2023_tpu.models.generator import init_generator  # noqa: E402
from mocha_sigasia2023_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from mocha_sigasia2023_tpu.parallel import shard_streams as jshard  # noqa: E402
from mocha_sigasia2023_tpu.runtime import stream as jstream  # noqa: E402

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models.cvae import CVAEConfig  # noqa: E402
from mocha_sigasia2023_torch.models.generator import GeneratorConfig  # noqa: E402
from mocha_sigasia2023_torch.parallel import distributed as pdist  # noqa: E402
from mocha_sigasia2023_torch.parallel import mesh as pmesh  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(2)
GEN = dict(encoder_dim=32, encoder_depth=1, encoder_heads=2,
           encoder_dim_head=16, encoder_mlp_dim=64,
           decoder_dim=32, decoder_depth=1, decoder_heads=2,
           decoder_dim_head=16, decoder_mlp_dim=64)
S, T, M = 8, 12, 64
SEED = 31


def _inputs():
    """tests/test_parallel.py:73-154's weights, features and constants."""
    cfg = JGenConfig(**GEN)
    cvae_cfg = dict(output_seq=cfg.num_tokens, latent_dim=32, depth=1,
                    nheads=2, feedforward_dim=64)
    key = jax.random.PRNGKey(0)
    params = init_generator(key, cfg)
    cvae_params = init_cvae(jax.random.fold_in(key, 1),
                            JCVAEConfig(**cvae_cfg))
    J = cfg.njoints + 1
    tok, dim = cfg.num_tokens, cfg.encoder_dim
    rng = np.random.RandomState(0)
    feats = {
        "encoded": rng.randn(S, T, tok, dim).astype(np.float32),
        "cnt": rng.randn(S, T, tok, dim).astype(np.float32),
        "pos_last": rng.randn(S, T, J, 3).astype(np.float32) * 0.1,
        "rot_last": np.tile(np.array([1, 0, 0, 0], np.float32),
                            (S, T, J, 1)),
        "vel_last": rng.randn(S, T, J, 3).astype(np.float32) * 0.1,
        "ang_last": rng.randn(S, T, J, 3).astype(np.float32) * 0.1,
        "rvel_last": rng.randn(S, T, 3).astype(np.float32) * 0.1,
        "rang_last": rng.randn(S, T, 3).astype(np.float32) * 0.1,
        "contact_last": (rng.rand(S, T, 2) > 0.5).astype(np.float32),
        "hips_speed_mean": rng.rand(S, T).astype(np.float32) + 0.5,
    }
    cha_cnt = rng.randn(M, tok * dim).astype(np.float32)
    mean = np.zeros((tok, dim), np.float32)
    std = np.ones((tok, dim), np.float32)
    consts = dict(
        Y_mean=np.zeros((J, 15), np.float32),
        Y_std=np.ones((J, 15), np.float32),
        cha_encoded=rng.randn(M, tok, dim).astype(np.float32),
        cha_cnt_flat=cha_cnt,
        cha_cnt_sq=np.sum(cha_cnt ** 2, axis=-1),
        cnt_mean=mean, cnt_std=std, src_cnt_mean=mean, src_cnt_std=std,
        cha_encoded_mean=mean, cha_encoded_std=std)
    parents = np.concatenate(
        [[-1], np.array([-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13,
                         14, 8, 16, 17, 18, 0, 20, 21, 22]) + 1])
    return cfg, params, cvae_cfg, cvae_params, feats, consts, parents


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX runs, the port's unsharded runs, and one launch of two
    ranks that runs every check of this module."""
    cfg, params, cvae_cfg, cvae_params, feats, consts, parents = _inputs()
    jconsts = jstream.RuntimeConsts(
        **{k: jnp.asarray(v) for k, v in consts.items()})
    jrun = jstream.make_batch_runner(params, cfg, cvae_params,
                                     JCVAEConfig(**cvae_cfg), jconsts,
                                     parents, deterministic=True)
    frame0, xs = jstream.stack_stream_inputs(feats)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    jax_out = {"unsharded": jax.tree.map(np.asarray,
                                         jrun(frame0, xs, keys))}
    jmesh = jmake_mesh()
    jax_out["sharded"] = jax.tree.map(
        np.asarray, jrun(*jshard(jmesh, frame0, xs, keys)))

    gen = convert.generator_from_jax(jax.tree.map(np.array, params),
                                     GeneratorConfig(**GEN), device="cpu")
    cvae = convert.cvae_from_jax(jax.tree.map(np.array, cvae_params),
                                 CVAEConfig(**cvae_cfg), device="cpu")
    tconsts = stream.RuntimeConsts(
        **{k: torch.as_tensor(v) for k, v in consts.items()})
    f0 = {k: torch.as_tensor(np.array(v)) for k, v in frame0.items()}
    txs = {k: torch.as_tensor(np.array(v)) for k, v in xs.items()}
    port = {}
    for det in (True, False):
        runner = stream.make_batch_runner(gen, cvae, tconsts, parents,
                                          deterministic=det, device="cpu")
        port[det] = runner(f0, txs, None if det else
                           torch.Generator().manual_seed(SEED))

    d = tmp_path_factory.mktemp("parallel")
    spec = {"dir": str(d), "port": pdist.free_port(),
            "gen_cfg": GEN, "cvae_cfg": cvae_cfg,
            "gen": gen.state_dict(), "cvae": cvae.state_dict(),
            "consts": tconsts._asdict(), "parents": parents,
            "frame0": f0, "xs": txs, "seed": SEED,
            "out": str(d / "serving.pt")}
    pdist.spawn(ranks.module_rank, 2, args=(spec,), device="cpu", threads=2)
    per_rank = [torch.load(d / f"collectives_{r}.pt", weights_only=False)
                for r in range(2)]
    sharded = torch.load(spec["out"], weights_only=False)
    return dict(jax=jax_out, port=port, ranks=per_rank, sharded=sharded)


def test_mesh_shapes(run):
    for r, got in enumerate(run["ranks"]):
        assert got["mesh"]["names"] == ("data", "model")
        assert got["mesh"]["shape"] == (2, 1)
        assert got["mesh"]["coord"] == (r, 2)
        assert got["flat"]["shape"] == (1, 2)
        assert got["flat"]["coord"] == (0, 1)


def test_shard_batch_gives_each_rank_its_block(run):
    X = torch.arange(16 * 3.0).reshape(16, 3)
    clips = [f"clip_{i}" for i in range(6)]
    for r, got in enumerate(run["ranks"]):
        assert torch.equal(got["X"], X[8 * r:8 * (r + 1)])
        assert got["clips"] == clips[3 * r:3 * (r + 1)]
        assert "5 rows do not split over a data axis of 2" in got["raised"]
    assert torch.equal(torch.cat([g["X"] for g in run["ranks"]]), X)


def test_shard_streams_cuts_the_stream_axis(run):
    for r, got in enumerate(run["ranks"]):
        assert torch.equal(got["f0"], torch.arange(8.0)[4 * r:4 * (r + 1)])
        assert torch.equal(got["xs"], torch.arange(24.0).reshape(3, 8)[
            :, 4 * r:4 * (r + 1)])


def test_replicate_broadcasts_rank_0(run):
    for got in run["ranks"]:
        assert torch.equal(got["rep"], torch.full((3,), 7.0))
        assert torch.equal(got["module"], torch.ones(2, 2))


def test_cross_rank_reductions(run):
    for got in run["ranks"]:
        assert torch.equal(got["mean"][0], torch.full((2, 2), 1.5))
        assert float(got["mean"][1]) == 0.5
        assert float(got["sum"]) == 3.0
        assert got["gathered"].tolist() == [[0, 10], [1, 11]]


def test_initialize_multihost_and_primary_host(run):
    """From the launcher's variables (parallel.spawn sets torchrun's), then
    from explicit arguments; rank 0 alone is primary."""
    for r, got in enumerate(run["ranks"]):
        assert got["from_env"] == (r, 2)
        assert got["env"] == {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2",
                              "RANK": str(r), "LOCAL_RANK": str(r)}
        assert (got["rank"], got["world"]) == (r, 2)
        assert got["backend"] == "gloo"
        assert got["device"] == got["explicit_device"] == "cpu"
        assert got["primary"] == (r == 0)


def test_is_primary_host_without_a_group_and_nccl_needs_cuda():
    assert pdist.is_primary_host()
    with pytest.raises(ValueError, match="gloo"):
        pdist.initialize_multihost("localhost:1", 1, 0, backend="nccl",
                                   device="cpu")


def test_data_parallel_size_is_the_jax_cli_rule():
    # the largest divisor of the batch at most the device count
    assert pmesh.data_parallel_size(64, 1) == 1
    assert pmesh.data_parallel_size(64, 8) == 8
    assert pmesh.data_parallel_size(64, 3) == 2
    assert pmesh.data_parallel_size(6, 4) == 3
    assert pmesh.data_parallel_size(7, 0) == 1


def _same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a = np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.shape == b.shape, (what, k)
        if k.endswith("_rot"):
            qd = np.abs(np.sum(a * b, axis=-1))
            np.testing.assert_array_less(1.0 - 1e-6, qd,
                                         err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6,
                                       err_msg=f"{what}: {k}")


def test_sharded_serving_deterministic_equals_unsharded_and_jax(run):
    got = run["sharded"]
    assert got["local_streams"] == S // 2
    assert got[True]["src_pos"].shape == (T, S, 25, 3)
    _same(got[True], run["port"][True], "port unsharded")
    _same(got[True], run["jax"]["unsharded"], "JAX unsharded")
    _same(got[True], run["jax"]["sharded"], "JAX sharded over 8 devices")


def test_sharded_serving_draws_the_unsharded_noise(run):
    got, want = run["sharded"][False], run["port"][False]
    _same(got, want, "port unsharded, same generator seed")
    # the noise moved the output: the check is not the deterministic one
    assert not np.allclose(np.asarray(want["trans_pos"]),
                           np.asarray(run["port"][True]["trans_pos"]))
