"""The port's layers, generator and CVAE against the JAX package.

Weights come from the JAX initializers and cross through
``generator_from_jax``/``cvae_from_jax`` (or a strict state-dict load for a
single layer).  Bounds from PARITY.md: layers 2e-5, generator 5e-5; the
deterministic CVAE sample 5e-5.  Widths are small (dim 32, 2 heads,
dim_head 16, depth 1); the 24-joint graph and 90 tokens are the rig's.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.models import graph as jgraph  # noqa: E402
from mocha_sigasia2023_tpu.models import layers as jl  # noqa: E402

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.models import layers as tl  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
CVAE_SMALL = dict(latent_dim=32, depth=1, nheads=2, feedforward_dim=64)
LAYER_TOL = 2e-5
MODEL_TOL = 5e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, jax_params):
    state = {k: torch.as_tensor(np.array(v, np.float32))
             for k, v in convert.flatten_pytree(_np(jax_params)).items()}
    module.load_state_dict(state, strict=True)
    return module


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=0)


KEY = jax.random.PRNGKey(0)


@torch.no_grad()
def test_primitives():
    x = _x(0, 3, 90, 32)
    p = jl.init_linear(KEY, 32, 48)
    _close(tl.linear(_load(torch.nn.Linear(32, 48), p), torch.as_tensor(x)),
           jl.linear(p, jnp.asarray(x)), LAYER_TOL)
    ln = {"weight": jnp.asarray(_x(1, 32)), "bias": jnp.asarray(_x(2, 32))}
    _close(tl.layer_norm(_load(torch.nn.LayerNorm(32), ln),
                         torch.as_tensor(x)),
           jl.layer_norm(ln, jnp.asarray(x)), LAYER_TOL)
    for name in ("gelu", "leaky_relu", "mean_variance_norm"):
        _close(getattr(tl, name)(torch.as_tensor(x)),
               getattr(jl, name)(jnp.asarray(x)), LAYER_TOL)
    const = np.ones((2, 90, 4), np.float32)       # var == 0 edge
    _close(tl.mean_variance_norm(torch.as_tensor(const)),
           jl.mean_variance_norm(jnp.asarray(const)), LAYER_TOL)


def test_mean_variance_norm_gradient_sums_to_zero_over_tokens():
    """Tokens far off zero with a small spread (an offset of 6, a spread of
    0.05, 90 tokens, float32), as the decoder's AdaIN feeds its attention:
    the exact gradient of mean_variance_norm sums to zero over the tokens.
    The port's float32 sum stays within 90 float32 spacings of the largest
    gradient, and its gradient matches jax.grad of the JAX layer."""
    x = 6.0 + 0.05 * _x(7, 8, 90, 256)
    w = _x(8, 8, 90, 256)
    xt = torch.as_tensor(x).requires_grad_(True)
    (tl.mean_variance_norm(xt) * torch.as_tensor(w)).sum().backward()
    g = xt.grad.numpy()
    jg = np.asarray(jax.grad(lambda a: jnp.sum(
        jl.mean_variance_norm(a) * jnp.asarray(w)))(jnp.asarray(x)))
    scale = float(np.abs(jg).max())
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-5 * scale)
    bar = 90 * np.finfo(np.float32).eps * scale
    assert float(np.abs(g.astype(np.float64).sum(axis=1)).max()) <= bar


@torch.no_grad()
def test_convolutions_and_stgcn_block():
    x = _x(3, 2, 16, 60, 24)
    A = jnp.asarray(jgraph.joint_adjacency("mocha", "distance", 2),
                    jnp.float32)
    At = torch.as_tensor(np.array(A))
    p1 = jl.init_conv2d(KEY, 16, 24)
    _close(tl.conv1x1(_load(torch.nn.Conv2d(16, 24, 1), p1),
                      torch.as_tensor(x)),
           jl.conv1x1(p1, jnp.asarray(x)), LAYER_TOL)
    pt = jl.init_conv2d(KEY, 16, 16, (5, 1))
    _close(tl.temporal_conv(_load(torch.nn.Conv2d(16, 16, (5, 1)), pt),
                            torch.as_tensor(x)),
           jl.temporal_conv(pt, jnp.asarray(x)), LAYER_TOL)
    pg = jl.init_conv2d(KEY, 16, 8 * 3)
    _close(tl.spatial_conv(_load(torch.nn.Conv2d(16, 24, 1), pg),
                           torch.as_tensor(x), At),
           jl.spatial_conv(pg, jnp.asarray(x), A), LAYER_TOL)
    ps = jl.init_stgcn_block(KEY, 16, 8, 3, 5)
    _close(tl.stgcn_block(_load(tl.stgcn_params(16, 8, 3, 5), ps),
                          torch.as_tensor(x), At),
           jl.stgcn_block(ps, jnp.asarray(x), A), LAYER_TOL)


@pytest.mark.parametrize("adain", [False, True])
@torch.no_grad()
def test_attention_layer(adain):
    src, tar = _x(4, 2, 90, 32), _x(5, 2, 90, 32)
    p = jl.init_attention(KEY, 32, 2, 16)
    t = tl.attention(_load(tl.attention_params(32, 2, 16), p),
                     torch.as_tensor(src),
                     torch.as_tensor(tar) if adain else None, heads=2,
                     adain=adain)
    j = jl.attention(p, jnp.asarray(src), jnp.asarray(tar) if adain else None,
                     heads=2, adain=adain)
    _close(t, j, LAYER_TOL)


@torch.no_grad()
def test_feedforward_adain_transformer():
    x, sty = _x(6, 2, 90, 32), _x(7, 2, 90, 32)
    pf = jl.init_feedforward(KEY, 32, 64)
    ff = torch.nn.ModuleDict({"w1": torch.nn.Linear(32, 64),
                              "w2": torch.nn.Linear(64, 32)})
    _close(tl.feedforward(_load(ff, pf), torch.as_tensor(x)),
           jl.feedforward(pf, jnp.asarray(x)), LAYER_TOL)
    pa = jl.init_adain(KEY, 32, 32)
    ad = torch.nn.ModuleDict({"fc1": torch.nn.Linear(32, 64),
                              "fc2": torch.nn.Linear(64, 64)})
    _close(tl.adain(_load(ad, pa), torch.as_tensor(x), torch.as_tensor(sty)),
           jl.adain(pa, jnp.asarray(x), jnp.asarray(sty)), LAYER_TOL)
    for adain_on in (False, True):
        p = jl.init_transformer(KEY, 32, 2, 2, 16, 64, adain_on)
        m = _load(tl.transformer_params(32, 2, 2, 16, 64, adain_on), p)
        s_t = torch.as_tensor(sty) if adain_on else None
        s_j = jnp.asarray(sty) if adain_on else None
        _close(tl.transformer(m, torch.as_tensor(x), s_t, heads=2,
                              adain_on=adain_on),
               jl.transformer(p, jnp.asarray(x), s_j, heads=2,
                              adain_on=adain_on), LAYER_TOL)


def _adain_layer_grads(p, x, sty, w, framework, dtype):
    """The gradient of sum(w * layer(x, sty)) over one AdaIN transformer
    layer's parameters, flattened, through the JAX package or the port
    (its training forward: plain attention) in ``dtype``."""
    if framework == "jax":
        with jax.enable_x64(dtype == np.float64):
            def f(q):
                return jnp.sum(jnp.asarray(w, dtype) * jl.transformer(
                    q, jnp.asarray(x, dtype), jnp.asarray(sty, dtype),
                    heads=2, adain_on=True))
            g = jax.grad(f)(jax.tree.map(lambda a: jnp.asarray(a, dtype), p))
            return {k: np.asarray(v, np.float64)
                    for k, v in convert.flatten_pytree(_np(g)).items()}
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    m = _load(tl.transformer_params(32, 1, 2, 16, 64, True), p).to(tdt)
    out = tl.transformer(m, torch.as_tensor(x, dtype=tdt),
                         torch.as_tensor(sty, dtype=tdt), heads=2,
                         adain_on=True, train=True)
    (torch.as_tensor(w, dtype=tdt) * out).sum().backward()
    return {k: v.grad.double().numpy() for k, v in m.named_parameters()}


@pytest.mark.parametrize("gain,resolved", [(1.0, True), (1e-5, False)])
def test_adain_gain_near_zero_is_beyond_float32_in_both(gain, resolved):
    """An AdaIN channel whose gain 1 + gamma nears 0 (gamma near -1)
    beside a shift beta = 1 leaves that channel's output 1 + gain x the
    normalized input, and float32 keeps about ``gain`` of its spread.  At
    gain 1e-5 the float32 gradients of the AdaIN's fc2 miss the training
    parity bar (rtol 1e-3 / atol 1e-5 x the tensor's largest) against
    float64 in the JAX package and in the port alike; at gain 1 both meet
    it.  The two agree in float64 at either gain."""
    p = _np(jl.init_transformer(KEY, 32, 1, 2, 16, 64, True))
    fc2 = p["layers"][0]["adain"]["fc2"]
    fc2["weight"] = np.array(fc2["weight"])
    fc2["bias"] = np.array(fc2["bias"])
    fc2["weight"][[0, 32]] = 0.0
    fc2["bias"][0], fc2["bias"][32] = gain - 1.0, 1.0
    x, sty, w = 3.0 + _x(10, 2, 90, 32), _x(11, 2, 90, 32), _x(12, 2, 90, 32)
    names = ("layers.0.adain.fc2.weight", "layers.0.adain.fc2.bias")
    g64 = {fw: _adain_layer_grads(p, x, sty, w, fw, np.float64)
           for fw in ("jax", "torch")}
    for name in names:
        np.testing.assert_allclose(g64["torch"][name], g64["jax"][name],
                                   rtol=1e-7, atol=1e-9 * float(np.abs(
                                       g64["jax"][name]).max()))
    for fw in ("jax", "torch"):
        g32 = _adain_layer_grads(p, x, sty, w, fw, np.float32)
        of_bar = max(float((np.abs(g32[n] - g64["jax"][n]) / (
            1e-3 * np.abs(g64["jax"][n])
            + 1e-5 * np.abs(g64["jax"][n]).max())).max()) for n in names)
        assert (of_bar <= 1.0) == resolved, (fw, of_bar)


@pytest.fixture(scope="module")
def gens():
    jcfg = jgen.GeneratorConfig(**SMALL)
    params = jgen.init_generator(jax.random.PRNGKey(1), jcfg)
    tg = convert.generator_from_jax(_np(params), tgen.GeneratorConfig(**SMALL),
                                    device="cpu")
    return jcfg, params, tg


@torch.no_grad()
def test_generator_encode_decode_forward(gens):
    jcfg, params, tg = gens
    src, cha = _x(8, 3, 60, 24, 15), _x(9, 3, 60, 24, 15)
    e_t = tgen.encode(tg, torch.as_tensor(src))
    e_j = jgen.encode(params, jcfg, jnp.asarray(src))
    _close(e_t, e_j, MODEL_TOL)
    _close(tgen.embed_tokens(tg, torch.as_tensor(src)),
           jgen.embed_tokens(params, jcfg, jnp.asarray(src)), MODEL_TOL)
    _close(tgen.content_feature(e_t), jgen.content_feature(e_j), MODEL_TOL)
    c_j = jgen.encode(params, jcfg, jnp.asarray(cha))
    _close(tgen.decode(tg, torch.as_tensor(np.array(e_j)),
                       torch.as_tensor(np.array(c_j))),
           jgen.decode(params, jcfg, e_j, c_j), MODEL_TOL)
    _close(tgen.forward(tg, torch.as_tensor(src), torch.as_tensor(cha)),
           jgen.forward(params, jcfg, jnp.asarray(src), jnp.asarray(cha)),
           MODEL_TOL)
    feats_t = tgen.forward(tg, torch.as_tensor(src), torch.as_tensor(cha),
                           extract_feature=True)
    feats_j = jgen.forward(params, jcfg, jnp.asarray(src), jnp.asarray(cha),
                           extract_feature=True)
    for a, b in zip(feats_t, feats_j):
        _close(a, b, MODEL_TOL)


def test_parameter_paths_are_the_jax_pytree_paths():
    """At the shipped width: the state dict is the flattened JAX pytree,
    with the same shapes, for both models."""
    cfg = jgen.GeneratorConfig()
    jshapes = jax.eval_shape(lambda k: jgen.init_generator(k, cfg), KEY)
    flat = convert.flatten_pytree(jax.tree.map(lambda s: np.empty(s.shape),
                                               jshapes))
    tg = tgen.Generator(tgen.GeneratorConfig())
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in tg.state_dict().items()}
    assert "encoder.layers.0.attn.to_q.weight" in flat
    ccfg = jcvae.CVAEConfig()
    cshapes = jax.eval_shape(lambda k: jcvae.init_cvae(k, ccfg), KEY)
    cflat = convert.flatten_pytree(jax.tree.map(lambda s: np.empty(s.shape),
                                                cshapes))
    tc = tcvae.CVAE(tcvae.CVAEConfig())
    assert {k: tuple(v.shape) for k, v in cflat.items()} == {
        k: tuple(v.shape) for k, v in tc.state_dict().items()}


def test_numpy_init_is_seeded_and_finite():
    cfg = tgen.GeneratorConfig(**SMALL)
    a = tgen.init_generator(cfg, seed=3, device="cpu")
    b = tgen.init_generator(cfg, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
        assert torch.isfinite(va).all()
    c = tcvae.init_cvae(tcvae.CVAEConfig(**CVAE_SMALL), seed=4, device="cpu")
    assert torch.equal(c.prior.layers[0].norm1.weight, torch.ones(32))
    assert not any(p.requires_grad for p in c.parameters())


@pytest.fixture(scope="module")
def cvaes():
    jcfg = jcvae.CVAEConfig(**CVAE_SMALL)
    params = jcvae.init_cvae(jax.random.PRNGKey(2), jcfg)
    tc = convert.cvae_from_jax(_np(params), tcvae.CVAEConfig(**CVAE_SMALL),
                               device="cpu")
    return jcfg, params, tc


@torch.no_grad()
def test_cvae_prior_and_deterministic_sample(cvaes):
    jcfg, params, tc = cvaes
    c = _x(10, 2, 180, 32)
    mu_t, lv_t = tcvae.prior(tc, torch.as_tensor(c))
    mu_j, lv_j = jcvae.prior(params, jnp.asarray(c), jcfg)
    _close(mu_t, mu_j, MODEL_TOL)
    _close(lv_t, lv_j, MODEL_TOL)
    _close(tcvae.sample(tc, torch.as_tensor(c), deterministic=True),
           jcvae.sample(params, jnp.asarray(c), jcfg, deterministic=True),
           MODEL_TOL)
    z = _x(11, 2, 32)
    _close(tcvae.decode(tc, torch.as_tensor(z), torch.as_tensor(c)),
           jcvae.decode(params, jnp.asarray(z), jnp.asarray(c), jcfg),
           MODEL_TOL)


@torch.no_grad()
def test_cvae_layers_and_positions(cvaes):
    jcfg, params, tc = cvaes
    np.testing.assert_array_equal(
        tcvae.sincos_positional_encoding(180, 32),
        jcvae.sincos_positional_encoding(180, 32))
    x = _x(12, 2, 92, 32)
    layer_j = params["prior"]["layers"][0]
    layer_t = tc.prior.layers[0]
    for n in (None, 2):
        _close(tcvae.encoder_layer(layer_t, torch.as_tensor(x), nheads=2,
                                   out_tokens=n),
               jcvae.encoder_layer(layer_j, jnp.asarray(x), nheads=2,
                                   out_tokens=n), LAYER_TOL)
    mem = _x(13, 2, 91, 32)
    _close(tcvae.decoder_layer(tc.decoder["layers"][0],
                               torch.as_tensor(x[:, :90]),
                               torch.as_tensor(mem), nheads=2),
           jcvae.decoder_layer(params["decoder"]["layers"][0],
                               jnp.asarray(x[:, :90]), jnp.asarray(mem),
                               nheads=2), LAYER_TOL)


def test_stochastic_sample_needs_a_generator(cvaes):
    _, _, tc = cvaes
    c = torch.as_tensor(_x(14, 2, 180, 32))
    with pytest.raises(ValueError, match="Generator"):
        tcvae.sample(tc, c)
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = tcvae.sample(tc, c, generator=g1)
        b = tcvae.sample(tc, c, generator=g2)
    assert torch.equal(a, b) and torch.isfinite(a).all()
