"""Attention outside the tuned kernels' envelope, against the JAX package.

The JAX kernel takes any (N, M, d) block, and the JAX generator runs any
``GeneratorConfig``.  The port sends what its tuned kernels do not take
(more than 128 keys, d not a multiple of 64, views TMA cannot copy) to
``csrc/attention_general.cu``, whose plain version is the same
``attention_reference``.  Here that plain version is held to the JAX
Pallas kernel in interpret mode and to the JAX einsum at such shapes
(float32 at atol 2e-5 / rtol 1e-4, tests/test_ops.py; bfloat16 compared in
float32 at 8e-3 / 8e-3, the bf16 kernels' contract), the general kernel's
two-pass arithmetic is emulated on the CPU against the plain version, and
a generator with 120-frame windows (180 tokens), encoder heads of 96 and
decoder heads of 32 is held to the JAX generator at the bars of
tests/test_torch_models.py (5e-5).  The kernel itself runs only on the
card (chip_smoke.py's ``kernels (general)`` phase).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.ops.attention import (  # noqa: E402
    fused_attention as jfused)

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.ops import attention as tattn  # noqa: E402

torch.set_num_threads(2)
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (8e-3, 8e-3)}
MODEL_TOL = 5e-5
# (B, H, N, M, d): more keys than 128, narrow and odd head dims, one query
SHAPES = [(2, 3, 180, 180, 32), (1, 2, 180, 180, 96), (1, 2, 17, 300, 128),
          (2, 2, 90, 90, 50), (2, 3, 1, 45, 96), (1, 1, 1, 1, 1)]
# the generator of a config outside the envelope, at narrow widths
WIDE = dict(nframes=120, encoder_dim=32, encoder_heads=2, encoder_dim_head=96,
            encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
            decoder_heads=2, decoder_dim_head=32, decoder_mlp_dim=64,
            decoder_depth=1)
KEYS = 64   # keys a tile of the general kernel


def _qkv(b, h, n, m, d, seed, dtype):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, r, d).astype(np.float32) for r in (n, m, m))
    return [torch.as_tensor(a).to(dtype) for a in (q, k, v)]


def _jax_einsum(q, k, v, scale):
    """The JAX generator's einsum path on float32 operands (bf16 inputs
    upcast first)."""
    dots = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(dots, -1), v)


def _j(t):
    return jnp.asarray(t.float().numpy(), jnp.dtype(str(t.dtype)[6:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel_and_einsum(shape, dtype):
    b, h, n, m, d = shape
    q, k, v = _qkv(b, h, n, m, d, seed=n + m + d, dtype=dtype)
    scale = d ** -0.5
    out = tattn.fused_attention(q, k, v, scale=scale)
    assert out.dtype == dtype and out.shape == (b, h, n, d)
    kernel = np.asarray(jfused(_j(q), _j(k), _j(v), scale=scale,
                               interpret=True).astype(jnp.float32))
    einsum = np.asarray(_jax_einsum(*(jnp.asarray(t.float().numpy())
                                      for t in (q, k, v)), scale))
    atol, rtol = TOL[str(dtype)[6:]]
    got = out.float().numpy()
    np.testing.assert_allclose(got, kernel, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, einsum, atol=atol, rtol=rtol)
    assert tattn._route(q, k, v) == (
        "tuned" if m <= 128 and d % 64 == 0 else "general")


def _general_emulated(q, k, v, scale):
    """The general kernel's arithmetic: float32 logits, a first pass over
    64-key tiles for the row max and the row sum (rescaled when a tile
    raises the max), then P = exp(s - max) / sum rounded to v's dtype and
    P v summed in float32, the output rounded to q's dtype."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    m_run = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l_run = torch.zeros_like(m_run)
    for t0 in range(0, s.shape[-1], KEYS):
        tile = s[..., t0:t0 + KEYS]
        m_new = torch.maximum(m_run, tile.amax(-1, keepdim=True))
        l_run = (l_run * torch.exp(m_run - m_new)
                 + torch.exp(tile - m_new).sum(-1, keepdim=True))
        m_run = m_new
    p = (torch.exp(s - m_run) / l_run).to(v.dtype).float()
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_general_emulation_meets_contract(dtype, q_scale):
    """With logits near +-40 (q x 8) too, over 300 keys in five tiles."""
    q, k, v = _qkv(1, 2, 33, 300, 96, seed=7, dtype=dtype)
    q = (q.float() * q_scale).to(dtype)
    scale = 96 ** -0.5
    got = _general_emulated(q, k, v, scale).float()
    ref = tattn.attention_reference(q, k, v, scale).float()
    atol, rtol = TOL[str(dtype)[6:]]
    assert bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


@pytest.fixture(scope="module")
def wide_gens():
    jcfg = jgen.GeneratorConfig(**WIDE)
    params = jgen.init_generator(jax.random.PRNGKey(5), jcfg)
    tg = convert.generator_from_jax(jax.tree.map(np.asarray, params),
                                    tgen.GeneratorConfig(**WIDE),
                                    device="cpu")
    return jcfg, params, tg


@torch.no_grad()
def test_wide_generator_encode_decode_match_jax(wide_gens):
    """120-frame windows (180 tokens), heads of 96 in the encoder and 32 in
    the decoder: every attention of this generator is outside the tuned
    envelope, and the port runs it as the JAX generator does."""
    jcfg, params, tg = wide_gens
    assert tg.cfg.num_tokens == 180
    rng = np.random.RandomState(11)
    src, cha = (rng.randn(2, 120, 24, 15).astype(np.float32) for _ in "sc")
    e_t = tgen.encode(tg, torch.as_tensor(src))
    e_j = jgen.encode(params, jcfg, jnp.asarray(src))
    assert tuple(e_t.shape) == (2, 180, 32)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=MODEL_TOL,
                               rtol=0)
    c_j = jgen.encode(params, jcfg, jnp.asarray(cha))
    d_t = tgen.decode(tg, torch.as_tensor(np.array(e_j)),
                      torch.as_tensor(np.array(c_j)))
    d_j = jgen.decode(params, jcfg, e_j, c_j)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=MODEL_TOL,
                               rtol=0)
    # the shapes those attentions hand the kernel wrapper
    q = torch.empty(2, 180, 2, 96).transpose(1, 2)
    assert tattn._route(q, q, q) == "general"
    q = torch.empty(2, 180, 2, 32).transpose(1, 2)
    assert tattn._route(q, q, q) == "general"
