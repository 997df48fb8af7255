"""The port's attention wrapper and plain version against the JAX kernel.

On the CPU the wrapper runs its plain version (einsum, softmax, einsum);
it is held against the JAX Pallas kernel in interpret mode and the JAX
einsum path at the tolerance the JAX package uses for its kernel
(tests/test_ops.py: atol 2e-5, rtol 1e-4).  The CUDA kernel itself runs
only on the card (chip_smoke.py holds it against the plain version).
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


@pytest.mark.parametrize("case", ["dtype", "head_dim", "keys", "mismatch",
                                  "stride", "rank"])
def test_kernel_shape_checks_raise(case):
    """What the CUDA kernel does not take is refused before any launch."""
    q = torch.zeros(1, 2, 90, 64)
    k = torch.zeros(1, 2, 90, 64)
    v = torch.zeros(1, 2, 90, 64)
    if case == "dtype":
        q = q.double()
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 2, 90, 48) for _ in range(3))
    elif case == "keys":
        k = v = torch.zeros(1, 2, 200, 64)
    elif case == "mismatch":
        k = torch.zeros(1, 2, 90, 128)
    elif case == "stride":
        q = torch.zeros(1, 2, 64, 90).transpose(2, 3)
    elif case == "rank":
        q = torch.zeros(2, 90, 64)
    with pytest.raises((TypeError, ValueError)):
        tattn._check(q, k, v)


def test_kernel_shapes_of_the_main_path_pass_checks():
    for shape, m in (((128, 4, 90, 128), 90), ((64, 4, 90, 256), 90),
                     ((64, 4, 90, 256), 45)):
        q = torch.empty(shape)
        kv = torch.empty(shape[:2] + (m, shape[3]))
        tattn._check(q, kv, kv)
