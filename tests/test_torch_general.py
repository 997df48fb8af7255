"""Attention outside the tuned kernels' envelope, against the JAX package.

The JAX kernel takes any (N, M, d) block, and the JAX generator runs any
``GeneratorConfig``.  The port sends what its tuned kernels do not take
(more than 128 keys, d not a multiple of 64, views TMA cannot copy) to
``csrc/attention_general.cu``, whose plain version is the same
``attention_reference``.  Here that plain version is held to the JAX
Pallas kernel in interpret mode and to the JAX einsum at such shapes
(float32 at atol 2e-5 / rtol 1e-4, tests/test_ops.py; bfloat16 compared in
float32 at 8e-3 / 8e-3, the bf16 kernels' contract), the general kernel's
arithmetic (3xTF32 or exact bf16 products, logits resident or two
passes over the keys) is emulated on the CPU against the plain version,
its shared-memory plan is checked over a grid of shapes, and
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
SUM_COLS = 32   # head-dim columns the fp32 kernel sums apart, then adds
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
# (B, H, N, M, d): more keys than 128, narrow and odd head dims, one query
SHAPES = [(2, 3, 180, 180, 32), (1, 2, 180, 180, 96), (1, 2, 17, 300, 128),
          (2, 2, 90, 90, 50), (2, 3, 1, 45, 96), (1, 1, 1, 1, 1)]
# the generator of a config outside the envelope, at narrow widths
WIDE = dict(nframes=120, encoder_dim=32, encoder_heads=2, encoder_dim_head=96,
            encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
            decoder_heads=2, decoder_dim_head=32, decoder_mlp_dim=64,
            decoder_depth=1)


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


def _tf32_round(x):
    """TF32 rounding as the kernel's split does it: half a TF32 ulp added
    to the magnitude bits, the 13 low mantissa bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in 3xTF32: big = tf32(x), small = x - big (read truncated),
    a_small b_big + a_big b_small + a_big b_big."""
    a_big, b_big = _tf32_round(a), _tf32_round(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32(a, b):
    return _tf32_round(a) @ _tf32_round(b)


def _general_emulated(q, k, v, scale, resident, mm=_mm_3xtf32):
    """The general kernel's arithmetic.  Logits in fp32: float32 inputs
    through ``mm`` (3xTF32) summed per 32 head-dim columns and the sums
    added; bfloat16 inputs as exact products summed in fp32; scaled by
    scale * log2(e) in fp32, so that exp(s - max) is exp2 of the
    difference.  Resident path: the row max and sum over all keys at once.
    Two-pass path: the max and sum carried over 32-key tiles (the sum
    rescaled when a tile raises the max).  Then P = e / sum rounded to v's
    dtype from the final max and sum, P v through ``mm`` (float32) or
    summed in fp32 (bfloat16), the output rounded to q's dtype."""
    if q.dtype == torch.float32:
        kt = k.transpose(-1, -2)
        s = sum(mm(q[..., c:c + SUM_COLS], kt[..., c:c + SUM_COLS, :])
                for c in range(0, q.shape[-1], SUM_COLS))
    else:
        s = q.float() @ k.float().transpose(-1, -2)
    s = s * (torch.tensor(scale, dtype=torch.float32) * LOG2E)
    if resident:
        m_run = s.amax(-1, keepdim=True)
        l_run = torch.exp2(s - m_run).sum(-1, keepdim=True)
    else:
        m_run = torch.full(s.shape[:-1] + (1,), -float("inf"))
        l_run = torch.zeros_like(m_run)
        for t0 in range(0, s.shape[-1], tattn.GENERAL_KEYS):
            tile = s[..., t0:t0 + tattn.GENERAL_KEYS]
            m_new = torch.maximum(m_run, tile.amax(-1, keepdim=True))
            l_run = (l_run * torch.exp2(m_run - m_new)
                     + torch.exp2(tile - m_new).sum(-1, keepdim=True))
            m_run = m_new
    p = (torch.exp2(s - m_run) / l_run).to(v.dtype)
    if q.dtype == torch.float32:
        return mm(p, v)
    return (p.float() @ v.float()).to(q.dtype)


def _within(got, ref, dtype):
    atol, rtol = TOL[str(dtype)[6:]]
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def _emulation_inputs(n, m, d, dtype, q_scale, seed):
    q, k, v = _qkv(1, 2, n, m, d, seed=seed, dtype=torch.float32)
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 32, 50, 96, 300])
@pytest.mark.parametrize("side", ["resident", "two_pass"])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_general_emulation_meets_contract(dtype, d, side, q_scale):
    """Both paths of the kernel's arithmetic against the plain version at
    the dtype's contract, at M on each side of the plan's switch (the
    largest M whose logits stay resident, and one key more), with logits
    near +-40 at q x 8."""
    n = 33
    m = tattn.general_resident_keys(n, d, dtype) + (side == "two_pass")
    plan = tattn.general_plan(n, m, d, dtype)
    assert plan.resident == (side == "resident")
    q, k, v = _emulation_inputs(n, m, d, dtype, q_scale, seed=d + m)
    scale = d ** -0.5
    if q_scale > 1:
        logits = q.float() @ k.float().transpose(-1, -2) * scale
        assert float(logits.abs().max()) > 25
    got = _general_emulated(q, k, v, scale, plan.resident)
    assert got.dtype == dtype
    assert _within(got, tattn.attention_reference(q, k, v, scale), dtype)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_single_pass_tf32_misses_general_fp32_contract(q_scale):
    """At d = 96 and 300 keys, products in single-pass TF32 (both paths)
    leave the fp32 contract; 3xTF32 meets it."""
    q, k, v = _emulation_inputs(33, 300, 96, torch.float32, q_scale, seed=9)
    scale = 96 ** -0.5
    ref = tattn.attention_reference(q, k, v, scale)
    for resident in (True, False):
        assert _within(_general_emulated(q, k, v, scale, resident), ref,
                       torch.float32)
        assert not _within(_general_emulated(q, k, v, scale, resident,
                                             mm=_mm_tf32), ref,
                           torch.float32)


PLAN_N = [1, 16, 17, 64, 180, 1000]
PLAN_M = [1, 31, 32, 33, 128, 129, 180, 300, 360, 704, 705, 1000, 2048,
          4096]
PLAN_D = [1, 7, 8, 16, 32, 50, 64, 96, 100, 128, 129, 256, 300, 320, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_general_plan_fits_shared_memory(dtype):
    """Every plan on a grid up to M = 4,096 and d = 512 asks for at most
    232,448 bytes of shared memory, covers the call as the C entry checks
    it, and lays out what its smem counts: q (one chunk), two buffers (a
    k chunk or a v block; both on the two-pass path), and the logits when
    resident.  The path is resident exactly when that fits in
    GENERAL_RESIDENT_SMEM (half an SM), which is up to
    general_resident_keys."""
    esize = torch.empty((), dtype=dtype).element_size()
    step = 8 if esize == 4 else 16
    for n in PLAN_N:
        for d in PLAN_D:
            switch = tattn.general_resident_keys(n, d, dtype)
            assert switch >= 32
            for m in PLAN_M + [switch, switch + 1]:
                p = tattn.general_plan(n, m, d, dtype)
                assert p.smem <= tattn.SMEM_LIMIT
                assert p.rows % 16 == 0 and 16 <= p.rows <= 64
                assert p.rows >= min(n, 64)
                assert p.depth >= d and p.depth % step == 0
                assert p.chunk * p.chunks >= p.depth and p.chunk % step == 0
                assert p.col_block * p.col_blocks >= p.depth
                assert p.col_block % step == 0
                assert p.col_block in (32, 64, 96, 128)
                assert p.keys >= m and p.keys % tattn.GENERAL_KEYS == 0
                q_elems = p.rows * p.q_stride if p.chunks == 1 else 0
                logits = p.rows * p.keys * 4
                assert p.smem == (q_elems + 2 * p.buffer) * esize + (
                    logits if p.resident else 0)
                k_part = ((p.rows if p.chunks > 1 else 0)
                          + tattn.GENERAL_KEYS) * p.c_stride
                v_part = tattn.GENERAL_KEYS * p.v_stride
                assert p.buffer == (max(k_part, v_part) if p.resident
                                    else k_part + v_part)
                if p.resident:
                    assert p.smem <= tattn.GENERAL_RESIDENT_SMEM
                assert p.resident == (m <= switch), (n, m, d)


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
