"""Reference checkpoints and the config reader of the port, against JAX.

``reference_generator_sd``/``reference_cvae_sd`` lay JAX-package weights
out as the reference's PyTorch state dicts (model.py's and model_CVAE.py's
key names, optional DataParallel prefix, the fixed buffers present).  The
JAX package's own strict converters must give back exactly the weights
they came from, which holds the helper to the JAX package.  The port's
converters must then give modules whose outputs equal those loaded from
the JAX pytree.  ``get_config`` (no PyYAML in the package) must equal
``yaml.safe_load`` on the configs.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("jax")
import jax  # noqa: E402

from mocha_sigasia2023_tpu.models import convert as jconvert  # noqa: E402
from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.utils import config as jconfig  # noqa: E402

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.utils import config as tconfig  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
CVAE_SMALL = dict(latent_dim=32, depth=1, nheads=2, feedforward_dim=64)


# ---------------------------------------------------------------------------
# reference-layout state dicts (shared with tests/test_torch_cli.py)
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def reference_generator_sd(params, prefix=""):
    """JAX generator params -> a reference Generator state dict."""
    sd = {}

    def lin(key, p):
        sd[key + ".weight"] = _t(p["weight"])
        if "bias" in p:
            sd[key + ".bias"] = _t(p["bias"])

    def stgcn(key, p):
        lin(key + ".blk.gcn.conv", p["gcn"])
        lin(key + ".blk.tcn", p["tcn"])

    sd["pos_emb"] = _t(params["pos_emb"])
    lin("mot_embedding.1", params["embed"]["conv_in"])
    stgcn("mot_embedding.2", params["embed"]["joint"])
    stgcn("mot_embedding.5", params["embed"]["body"])
    for part in ("encoder", "decoder"):
        for i, layer in enumerate(params[part]["layers"]):
            base = f"{part}.layers.{i}"
            a = layer["attn"]
            lin(f"{base}.1.to_q.1", a["to_q"])
            lin(f"{base}.1.to_k.1", a["to_k"])
            lin(f"{base}.1.to_v", a["to_v"])
            if "to_out" in a:
                lin(f"{base}.1.to_out.0", a["to_out"])
            lin(f"{base}.2.net.0", layer["ff"]["w1"])
            lin(f"{base}.2.net.3", layer["ff"]["w2"])
            if "adain" in layer:
                lin(f"{base}.0.style.2", layer["adain"]["fc1"])
                lin(f"{base}.0.style.4", layer["adain"]["fc2"])
    stgcn("to_mot.1", params["head"]["body"])
    stgcn("to_mot.4", params["head"]["joint"])
    lin("to_mot.6", params["head"]["conv_out"])
    # fixed buffers: adjacency stacks and pooling matrices
    for key in ("mot_embedding.2.A_j", "mot_embedding.5.A_b", "to_mot.1.A_b",
                "to_mot.4.A_j", "mot_embedding.3.weight", "to_mot.3.weight"):
        sd[key] = torch.ones(3, 4)
    return {prefix + k: v for k, v in sd.items()}


def _flat(tree, key):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{key}.{k}"))
        return out
    return {key: _t(tree)}


def reference_cvae_sd(params, prefix=""):
    """JAX CVAE params -> a reference CVAE state dict."""
    sd = {}
    for part, ref in (("prior", "prior_net"), ("posterior", "encoder")):
        sd[f"{ref}.mu_token"] = _t(params[part]["mu_token"])
        sd[f"{ref}.logvar_token"] = _t(params[part]["logvar_token"])
        for i, layer in enumerate(params[part]["layers"]):
            sd.update(_flat(layer, f"{ref}.encoder.layers.{i}"))
        sd[f"{ref}.pos_encoder.pe"] = torch.ones(5, 1, 4)
    for i, layer in enumerate(params["decoder"]["layers"]):
        sd.update(_flat(layer, f"decoder.decoder.layers.{i}"))
    sd["decoder.pos_encoder.pe"] = torch.ones(5, 1, 4)
    return {prefix + k: v for k, v in sd.items()}


def save_reference_checkpoints(path_dir, params, cparams, gen_params=None):
    """Write ``gen.pt`` ({'gen', 'gen_ema', 'gen_opt'}, EMA = ``params``)
    and ``cvae.pt`` (a bare state dict) as the reference trainers do."""
    gen_path = os.path.join(str(path_dir), "gen.pt")
    cvae_path = os.path.join(str(path_dir), "cvae.pt")
    torch.save({"gen": reference_generator_sd(gen_params or params),
                "gen_ema": reference_generator_sd(params, "module."),
                "gen_opt": {"state": {}, "param_groups": [{"lr": 1e-4}]}},
               gen_path)
    torch.save(reference_cvae_sd(cparams), cvae_path)
    return gen_path, cvae_path


# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def weights():
    jcfg = jgen.GeneratorConfig(**SMALL)
    params = _np(jgen.init_generator(jax.random.PRNGKey(21), jcfg))
    other = _np(jgen.init_generator(jax.random.PRNGKey(22), jcfg))
    cparams = _np(jcvae.init_cvae(jax.random.PRNGKey(23),
                                  jcvae.CVAEConfig(**CVAE_SMALL)))
    return params, other, cparams


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_layout_helper_matches_jax_converters(weights, prefix):
    params, _, cparams = weights
    _assert_trees_equal(
        jconvert.generator_from_torch(reference_generator_sd(params, prefix),
                                      1, 1, strict=True), params)
    _assert_trees_equal(
        jconvert.cvae_from_torch(reference_cvae_sd(cparams, prefix), 1,
                                 strict=True), cparams)


def _encode_decode(gen):
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.standard_normal((3, 60, 24, 15)).astype(np.float32))
    enc = tgen.encode(gen, x)
    return enc, tgen.decode(gen, enc, enc.flip(0))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_generator_from_torch_equals_generator_from_jax(weights, prefix):
    params = weights[0]
    cfg = tgen.GeneratorConfig(**SMALL)
    got = convert.generator_from_torch(reference_generator_sd(params, prefix),
                                       cfg, device="cpu")
    want = convert.generator_from_jax(params, cfg, device="cpu")
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    for a, b in zip(_encode_decode(got), _encode_decode(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", [0, 2])
def test_pytree_from_state_dict_inverts_the_jax_load(weights, which):
    """A port module's state_dict back to the JAX pytree it was loaded
    from: the same containers (lists of layers) and the same bits."""
    params = weights[which]
    module = (convert.generator_from_jax(params, tgen.GeneratorConfig(**SMALL),
                                         device="cpu") if which == 0 else
              convert.cvae_from_jax(params, tcvae.CVAEConfig(**CVAE_SMALL),
                                    device="cpu"))
    tree = convert.pytree_from_state_dict(module.state_dict())
    _assert_trees_equal(tree, params)
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_cvae_from_torch_equals_cvae_from_jax(weights, prefix):
    cparams = weights[2]
    cfg = tcvae.CVAEConfig(**CVAE_SMALL)
    got = convert.cvae_from_torch(reference_cvae_sd(cparams, prefix), cfg,
                                  device="cpu")
    want = convert.cvae_from_jax(cparams, cfg, device="cpu")
    c = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (2, 180, 32)).astype(np.float32))
    assert torch.equal(tcvae.sample(got, c, deterministic=True),
                       tcvae.sample(want, c, deterministic=True))
    assert torch.equal(
        tcvae.sample(got, c, generator=torch.Generator().manual_seed(4)),
        tcvae.sample(want, c, generator=torch.Generator().manual_seed(4)))


def test_load_reference_generator_checkpoint(weights, tmp_path):
    """The EMA branch is read by default, ``use_ema=False`` reads 'gen'; the
    file loads with ``weights_only``."""
    params, other, cparams = weights
    gen_path, cvae_path = save_reference_checkpoints(tmp_path, params,
                                                     cparams, other)
    cfg = tgen.GeneratorConfig(**SMALL)
    ema = convert.load_reference_generator_checkpoint(gen_path, cfg,
                                                      device="cpu")
    raw = convert.load_reference_generator_checkpoint(gen_path, cfg,
                                                      use_ema=False,
                                                      device="cpu")
    for got, src in ((ema, params), (raw, other)):
        want = convert.generator_from_jax(src, cfg, device="cpu")
        for a, b in zip(_encode_decode(got), _encode_decode(want)):
            assert torch.equal(a, b)
    sd = convert.load_torch_file(cvae_path)
    cvae = convert.cvae_from_torch(sd, tcvae.CVAEConfig(**CVAE_SMALL),
                                   device="cpu")
    assert torch.equal(cvae.prior.mu_token,
                       torch.as_tensor(cparams["prior"]["mu_token"]))


def _renamed(sd, old, new):
    out = dict(sd)
    out[new] = out.pop(old)
    return out


@pytest.mark.parametrize("kind", ["dropped", "renamed"])
def test_a_missing_reference_key_raises(weights, kind):
    sd = reference_generator_sd(weights[0])
    key = "decoder.layers.0.0.style.4.bias"
    sd = ({k: v for k, v in sd.items() if k != key} if kind == "dropped"
          else _renamed(sd, key, "decoder.layers.0.0.style.5.bias"))
    with pytest.raises(KeyError, match="style.4.bias"):
        convert.generator_from_torch(sd, tgen.GeneratorConfig(**SMALL),
                                     device="cpu")
    csd = reference_cvae_sd(weights[2])
    csd = _renamed(csd, "prior_net.mu_token", "prior_net.mu")
    with pytest.raises(KeyError, match="prior_net.mu_token"):
        convert.cvae_from_torch(csd, tcvae.CVAEConfig(**CVAE_SMALL),
                                device="cpu")


def test_an_unread_reference_key_raises_under_strict(weights):
    cfg = tgen.GeneratorConfig(**SMALL)
    sd = dict(reference_generator_sd(weights[0]),
              **{"encoder.layers.0.3.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="encoder.layers.0.3.weight"):
        convert.generator_from_torch(sd, cfg, device="cpu")
    convert.generator_from_torch(sd, cfg, strict=False, device="cpu")
    csd = dict(reference_cvae_sd(weights[2]), **{"extra.bias": torch.ones(1)})
    with pytest.raises(ValueError, match="extra.bias"):
        convert.cvae_from_torch(csd, tcvae.CVAEConfig(**CVAE_SMALL),
                                device="cpu")


def test_attention_without_to_out():
    """heads == 1 and dim_head == dim: the reference has no to_out."""
    small = dict(SMALL, encoder_heads=1, encoder_dim_head=32)
    params = _np(jgen.init_generator(jax.random.PRNGKey(5),
                                     jgen.GeneratorConfig(**small)))
    assert "to_out" not in params["encoder"]["layers"][0]["attn"]
    sd = reference_generator_sd(params)
    assert not any(k.startswith("encoder.") and "to_out" in k for k in sd)
    cfg = tgen.GeneratorConfig(**small)
    got = convert.generator_from_torch(sd, cfg, device="cpu")
    want = convert.generator_from_jax(params, cfg, device="cpu")
    for a, b in zip(_encode_decode(got), _encode_decode(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

TINY_CONFIG = {
    "name": "model_tiny", "data_dir": "/tmp/cli_e2e0/datasets/mocha60",
    "dataset": {"mocha": {"parents": [-1, 0, 1, 2, 3, 0, 5, 6]}},
    "model": {"encoder_dim": 32, "encoder_depth": 1, "prj_dim": 32,
              "num_patches": -1,
              "graph": {"joint": {"layout": "mocha", "strategy": "distance",
                                  "max_hop": 2}}},
    "manualSeed": 1777, "lr_gen": 1e-4, "rec_w": 1, "nce_w": 0.1,
    "cvae": {"latent_dim": 32, "depth": 1, "rollout_steps": 4},
    "runtime": {"window": 60, "contact_bones": [5, 24], "dt": 1.0 / 60.0,
                "ik": {"enabled": True}},
    "flags": [True, False, None, "yes", "1e-4", "a: b", ""],
    "nested": [{"a": 1, "b": [1, 2]}, [3, [4]], "x"],
}


def _config_sources(tmp_path):
    tiny = tmp_path / "tiny.yaml"
    tiny.write_text(yaml.safe_dump(TINY_CONFIG))
    flow = tmp_path / "tiny_flow.yaml"
    flow.write_text(yaml.safe_dump(TINY_CONFIG, default_flow_style=True))
    return {
        "jax_config": os.path.join(REPO, "mocha_sigasia2023_tpu", "configs",
                                   "config.yaml"),
        "jax_dataset": os.path.join(REPO, "mocha_sigasia2023_tpu", "configs",
                                    "dataset.yaml"),
        "port_config": os.path.join(REPO, "mocha_sigasia2023_torch",
                                    "configs", "config.yaml"),
        "tiny_block": str(tiny), "tiny_flow": str(flow)}


@pytest.mark.parametrize("source", ["jax_config", "jax_dataset",
                                    "port_config", "tiny_block",
                                    "tiny_flow"])
def test_get_config_equals_yaml_safe_load(tmp_path, source):
    path = _config_sources(tmp_path)[source]
    with open(path) as f:
        want = yaml.safe_load(f)
    assert tconfig.get_config(path) == want


def test_port_config_sections_equal_the_jax_config():
    port = tconfig.get_config(os.path.join(
        REPO, "mocha_sigasia2023_torch", "configs", "config.yaml"))
    with open(os.path.join(REPO, "mocha_sigasia2023_tpu", "configs",
                           "config.yaml")) as f:
        jax_cfg = yaml.safe_load(f)
    for section in ("model", "cvae", "preprocess", "runtime", "dataset"):
        assert port[section] == jax_cfg[section], section
    for key in ("split_step", "tail_barrier", "loss_dtype", "mesh"):
        assert key not in port
    assert jgen.GeneratorConfig.from_dict(jax_cfg["model"])._asdict() == \
        tgen.GeneratorConfig.from_dict(port["model"])._asdict()
    small = dict(SMALL, graph={"bodypart": {"max_hop": 2}})
    assert jgen.GeneratorConfig.from_dict(small)._asdict() == \
        tgen.GeneratorConfig.from_dict(small)._asdict()


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: |\n  text\n",
                                  "a: [1, 2\n", "a: 'open\n",
                                  "a: 1\n---\nb: 2\n"])
def test_get_config_refuses_what_it_does_not_read(text):
    with pytest.raises(tconfig.ConfigError):
        tconfig.parse_yaml(text)


def test_get_model_list_matches_jax(tmp_path):
    assert tconfig.get_model_list(str(tmp_path / "none"), "gen") is None
    for name in ("gen_001.pt", "gen_002.msgpack", "gen_010.ckpt",
                 "gen_099.txt", "cvae_500.ckpt", "gen_003.orbax"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "gen_900.ckpt").mkdir()        # a directory is not listed
    for key in ("gen", "cvae", "prj"):
        got = tconfig.get_model_list(str(tmp_path), key)
        assert got == jconfig.get_model_list(str(tmp_path), key), key
    assert got is None
    assert tconfig.get_model_list(str(tmp_path), "gen").endswith(
        "gen_010.ckpt")


def test_print_composite_matches_jax():
    tree = {"gen": {"layers": [np.zeros((2, 3)), np.ones(4)],
                    "scale": 1.5},
            "pair": (np.zeros(()), "name"), "empty": {}}

    def printed(fn, data):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(data, beg=">")
        return buf.getvalue()

    want = printed(jconfig.print_composite, tree)
    assert printed(tconfig.print_composite, tree) == want
    as_tensors = {"gen": {"layers": [torch.zeros(2, 3), torch.ones(4)],
                          "scale": 1.5},
                  "pair": (torch.zeros(()), "name"), "empty": {}}
    assert printed(tconfig.print_composite, as_tensors) == want
