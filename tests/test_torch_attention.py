"""The port's attention wrapper and plain version against the JAX kernel.

On the CPU the wrapper runs its plain version (einsum, softmax, einsum);
it is held against the JAX Pallas kernel in interpret mode and the JAX
einsum path at the tolerance the JAX package uses for its kernel
(tests/test_ops.py: atol 2e-5, rtol 1e-4).  The CUDA kernel itself runs
only on the card (chip_smoke.py holds it against the plain version).

The float32 kernel's products run in 3xTF32 on the tensor cores.  Tests
further down emulate that arithmetic on the CPU and show why the split is
there: 3xTF32 holds the fp32 contract against a float64 reference at the
main-path widths and at logits near +-40, and single-pass TF32 does not.
The last tests emulate the bf16 kernel's arithmetic (bf16 operands, fp32
sums of exact products, P = e / sum rounded to bf16) against the bf16
plain version, the division the kernel forms, and flash attention's
deferred normalisation.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.ops.attention import (  # noqa: E402
    fused_attention as jfused)

from mocha_sigasia2023_torch.ops import attention as tattn  # noqa: E402

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 1e-4


def _qkv(shape, m, seed):
    b, h, n, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, n, d).astype(np.float32),
            rng.randn(b, h, m, d).astype(np.float32),
            rng.randn(b, h, m, d).astype(np.float32))


def _jax_einsum(q, k, v, scale):
    dots = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(dots, -1), v)


@pytest.mark.parametrize("shape,m", [((2, 4, 90, 128), 90),
                                     ((1, 4, 90, 256), 90),
                                     ((2, 2, 90, 64), 90),
                                     ((1, 2, 90, 64), 45)])
def test_plain_matches_jax_kernel_and_einsum(shape, m):
    q, k, v = _qkv(shape, m, seed=shape[-1] + m)
    scale = shape[-1] ** -0.5
    before = tattn.fused_attention.launches
    out = tattn.fused_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), scale=scale).numpy()
    assert tattn.fused_attention.launches == before
    assert out.shape == shape
    ref_kernel = np.asarray(jfused(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale=scale,
                                   interpret=True))
    ref_einsum = np.asarray(_jax_einsum(q, k, v, scale))
    np.testing.assert_allclose(out, ref_kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref_einsum, atol=ATOL, rtol=RTOL)
    plain = tattn.attention_reference(torch.as_tensor(q), torch.as_tensor(k),
                                      torch.as_tensor(v), scale).numpy()
    np.testing.assert_array_equal(out, plain)


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    tattn.fused_attention.launches = 0
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 2, 90, 64), 90, 3))
    for _ in range(3):
        tattn.fused_attention(q, k, v, scale=0.125)
    assert tattn.fused_attention.launches == 0


def test_strided_head_view_matches_contiguous():
    """The generator passes (B, N, H, d) projections viewed as (B, H, N, d)."""
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(2, 90, 4, 64).astype(np.float32))
    view = x.transpose(1, 2)
    out = tattn.fused_attention(view, view, view, scale=0.125)
    ref = tattn.attention_reference(view.contiguous(), view.contiguous(),
                                    view.contiguous(), 0.125)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["dtype", "mismatch", "stride", "rank",
                                  "empty"])
def test_kernel_shape_checks_raise(case):
    """What no CUDA kernel takes is refused before any launch."""
    q = torch.zeros(1, 2, 90, 64)
    k = torch.zeros(1, 2, 90, 64)
    v = torch.zeros(1, 2, 90, 64)
    if case == "dtype":
        q = q.double()
    elif case == "mismatch":
        k = torch.zeros(1, 2, 90, 128)
    elif case == "stride":
        q = torch.zeros(1, 2, 64, 90).transpose(2, 3)
    elif case == "rank":
        q = torch.zeros(2, 90, 64)
    elif case == "empty":
        k = v = torch.zeros(1, 2, 0, 64)
    with pytest.raises((TypeError, ValueError)):
        tattn._check(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_shapes_of_the_main_path_pass_checks(dtype):
    """The main path's shapes, as models/layers.attention views them
    ((B, N, H, d) projections transposed to (B, H, N, d)), reach the tuned
    kernels in both dtypes: the encoder (d = 128), the decoder (d = 256)
    and its M = 45 cross attention."""
    for (b, h, n, d), m in (((128, 4, 90, 128), 90), ((64, 4, 90, 256), 90),
                            ((64, 4, 90, 256), 45)):
        def head_view(rows):
            return torch.empty(b, rows, h * d, dtype=dtype).reshape(
                b, rows, h, d).transpose(1, 2)

        q, k, v = head_view(n), head_view(m), head_view(m)
        assert not q.is_contiguous()
        tattn._check(q, k, v)
        assert tattn._route(q, k, v) == "tuned", ((b, h, n, d), m, dtype)


@pytest.mark.parametrize("case,route", [
    ("main", "tuned"), ("keys_128", "tuned"), ("one_key", "tuned"),
    ("head_dim", "general"), ("keys", "general"),
    ("misaligned_start", "general"), ("misaligned_row_stride", "general"),
    ("bf16_misaligned_row_stride", "general"), ("bf16_main", "tuned")])
def test_route(case, route):
    """Shapes and layout alone pick the kernel: the tuned kernels take
    1 <= M <= 128 keys, d a multiple of 64 and views TMA can copy (16-byte
    starts and strides); the general kernel takes the rest, which the
    tuned kernels once refused."""
    q = torch.zeros(1, 2, 90, 64)
    k = torch.zeros(1, 2, 90, 64)
    v = torch.zeros(1, 2, 90, 64)
    if case == "keys_128":
        k = v = torch.zeros(1, 2, 128, 64)
    elif case == "one_key":
        k = v = torch.zeros(1, 2, 1, 64)
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 2, 90, 48) for _ in range(3))
    elif case == "keys":
        k = v = torch.zeros(1, 2, 200, 64)
    elif case == "misaligned_start":   # 4 bytes past a 16-byte boundary
        q = torch.zeros(1 * 2 * 90 * 64 + 1)[1:].view(1, 2, 90, 64)
    elif case == "misaligned_row_stride":   # rows 65 floats apart
        q = torch.zeros(1, 2, 90, 65)[..., :64]
    elif case == "bf16_misaligned_row_stride":   # rows 130 bytes apart
        q, k, v = (torch.zeros(1, 2, 90, 65, dtype=torch.bfloat16)[..., :64]
                   for _ in range(3))
    elif case == "bf16_main":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    tattn._check(q, k, v)
    assert tattn._route(q, k, v) == route


def test_unit_dims_take_any_stride():
    """A dimension of extent 1 is never stepped, so its stride is free."""
    q, k, v = (torch.zeros(256).as_strided((1, 1, 1, 64), (7, 5, 3, 1))
               for _ in range(3))
    tattn._check(q, k, v)
    assert tattn._route(q, k, v) == "tuned"


# ---------------------------------------------------------------------------
# 3xTF32 numerics, emulated on the CPU
# ---------------------------------------------------------------------------

CHUNK = 32   # head-dim columns the kernel sums before adding to the logits


def _tf32_round(x):
    """TF32 rounding as cvt.rna.tf32.f32 does it: round half away from zero
    on the int32 view (add half a TF32 ulp to the magnitude), then clear
    the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel does it: big = tf32(x), small = x - big (read
    truncated by the MMA), a_small b_big + a_big b_small + a_big b_big."""
    a_big, b_big = _tf32_round(a), _tf32_round(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32(a, b):
    return _tf32_round(a) @ _tf32_round(b)


def _attention_emulated(q, k, v, scale, mm):
    """The kernel's order of work: logits summed per 32-column chunk,
    softmax in fp32 with the row max subtracted, P v, then / row sum."""
    logits = sum(mm(q[..., c:c + CHUNK], k[..., c:c + CHUNK].transpose(-1, -2))
                 for c in range(0, q.shape[-1], CHUNK)) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return mm(p, v) * (1.0 / p.sum(-1, keepdim=True))


def _exact(q, k, v, scale):
    q, k, v = (t.double() for t in (q, k, v))
    return torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v


def _within_contract(out, ref):
    return bool(((out.double() - ref).abs() <= ATOL + RTOL * ref.abs()).all())


# main-path widths with the batch cut to two heads; q x 8 puts the logits
# near +-40
NUMERICS_CASES = [(128, 1.0), (256, 1.0), (256, 8.0)]


def _numerics_inputs(d, q_scale):
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 2, 90, d), 90, seed=d))
    return q * q_scale, k, v, d ** -0.5


def test_tf32_rounding_emulation():
    one = 1.0
    ulp = 2.0 ** -10   # TF32 keeps 10 explicit mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                      -(one + ulp / 2), 3.0, one + 3 * ulp / 2],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), 3.0, one + 2 * ulp],
                        dtype=torch.float32)
    got = _tf32_round(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("d,q_scale", NUMERICS_CASES)
def test_3xtf32_emulation_meets_fp32_contract(d, q_scale):
    q, k, v, scale = _numerics_inputs(d, q_scale)
    out = _attention_emulated(q, k, v, scale, _mm_3xtf32)
    assert _within_contract(out, _exact(q, k, v, scale))


@pytest.mark.parametrize("d,q_scale", NUMERICS_CASES)
def test_single_pass_tf32_misses_fp32_contract(d, q_scale):
    q, k, v, scale = _numerics_inputs(d, q_scale)
    out = _attention_emulated(q, k, v, scale, _mm_tf32)
    assert not _within_contract(out, _exact(q, k, v, scale))


# ---------------------------------------------------------------------------
# bf16 kernel numerics, emulated on the CPU
# ---------------------------------------------------------------------------

ATOL_BF16 = RTOL_BF16 = 8e-3   # the bf16 kernel against its plain version


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even), as float32."""
    return x.to(torch.bfloat16).float()


def _mm_k16(a, b):
    """a @ b as the bf16 kernel's wgmma sum it: each k16 step's 16 exact
    products summed, then added to an fp32 accumulator step after step, in
    the kernel's chunk order (64 columns of d, or 16 keys, at a time)."""
    acc = None
    for c in range(0, a.shape[-1], 16):
        part = (a[..., c:c + 16].double()
                @ b[..., c:c + 16, :].double()).float()
        acc = part if acc is None else acc + part
    return acc


def _div_kernel(e, total):
    """e / total as the bf16 kernel forms it: inv = 1 / total rounded,
    q = e * inv, then one correction from the residual e - total * q (an
    FMA on the card, exact here in float64)."""
    inv = 1.0 / total
    q = e * inv
    r = (e.double() - total.double() * q.double()).float()
    return (q.double() + r.double() * inv.double()).float()


def _attention_bf16_emulated(q, k, v, scale, deferred=False):
    """The bf16 kernel's arithmetic: q, k, v in bf16; logits as fp32 sums of
    exact products; fp32 softmax; P = e / sum rounded to bf16; P v summed
    in fp32 and rounded to bf16.  With ``deferred``, flash attention's
    order instead: e rounded to bf16, (e v) / sum at the output."""
    q, k, v = _bf16(q), _bf16(k), _bf16(v)
    x = _mm_k16(q, k.transpose(-1, -2)) * scale
    e = torch.exp(x - x.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    if deferred:
        return _bf16(_mm_k16(_bf16(e), v) / total)
    return _bf16(_mm_k16(_bf16(_div_kernel(e, total.expand_as(e))), v))


def _bf16_inputs(d, q_scale):
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 2, 90, d), 90, seed=d))
    return q * q_scale, k, v, d ** -0.5


def _bf16_plain(q, k, v, scale):
    return tattn.attention_reference(
        *(t.to(torch.bfloat16) for t in (q, k, v)), scale).float()


def _outside_bf16_contract(out, ref):
    return int(((out - ref).abs() > ATOL_BF16 + RTOL_BF16 * ref.abs()).sum())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_bf16_emulation_meets_bf16_contract(d, q_scale):
    q, k, v, scale = _bf16_inputs(d, q_scale)
    out = _attention_bf16_emulated(q, k, v, scale)
    ref = _bf16_plain(q, k, v, scale)
    assert _outside_bf16_contract(out, ref) == 0
    # one bf16 rounding of P or of the output apart at most
    assert float((out - ref).abs().max()) <= 2.0 ** -7


def test_deferred_normalisation_at_large_logits():
    """Flash attention's order (e rounded to bf16, divided at the output)
    stays inside the contract at q x 8, but lands a bf16 ulp or more of an
    output in [1, 2) from the plain version, where the kernel's order lands
    within fp32 noise of it.  The kernel keeps the division before the
    rounding, as the TPU kernel has it."""
    q, k, v, scale = _bf16_inputs(256, 8.0)
    ref = _bf16_plain(q, k, v, scale)
    kernel = _attention_bf16_emulated(q, k, v, scale)
    deferred = _attention_bf16_emulated(q, k, v, scale, deferred=True)
    assert _outside_bf16_contract(deferred, ref) == 0
    assert float((deferred - ref).abs().max()) >= 2.0 ** -7
    assert float((kernel - ref).abs().max()) <= 2.0 ** -20


def test_kernel_division_rounds_as_fp32_division():
    """The kernel's reciprocal-and-correction gives e / sum exactly wherever
    the quotient is a normal fp32, for e in [0, 1] and sums in [1, 128]
    (the softmax's range); below that, subnormal P differ by a few
    subnormal ulps."""
    rng = np.random.RandomState(0)
    total = torch.as_tensor(rng.uniform(1, 128, 1_000_000).astype(np.float32))
    e = torch.as_tensor(rng.uniform(0, 1, 1_000_000).astype(np.float32))
    e[:1000] = 0.0
    e[1000:3000] = torch.exp(-torch.as_tensor(
        rng.uniform(0, 100, 2000).astype(np.float32)))
    got, want = _div_kernel(e, total), e / total
    normal = want.abs() >= torch.finfo(torch.float32).tiny
    assert torch.equal(got[normal], want[normal])
    assert float((got - want).abs().max()) <= 2.0 ** -140
