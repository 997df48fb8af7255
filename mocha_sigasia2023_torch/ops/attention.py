"""Fused attention: the CUDA kernel, its plain version, and the wrapper.

Counterpart of mocha_sigasia2023_tpu/ops/attention.py (the Pallas kernel
``_attn_kernel``).  ``fused_attention`` computes softmax(q k^T * scale) v
for (B, H, N, d) queries and (B, H, M, d) keys/values:

* on a CUDA tensor it launches ``csrc/attention.cu`` (fp32 in and out,
  products in 3xTF32 on the tensor cores) or raises — there is no
  fallback;
* on a CPU tensor it runs :func:`attention_reference`, the plain einsum
  form of mocha_sigasia2023_tpu/models/layers.py:227-232.

``fused_attention.launches`` counts kernel launches (CPU calls do not
count), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "attention.cu"
MAX_KEYS = 128
HEAD_DIM_MULTIPLE = 64
# the kernel's TMA copies need 16-byte-aligned starts and strides
ALIGN_BYTES = 16


def attention_reference(q, k, v, scale: float):
    """Plain PyTorch softmax(q k^T * scale) v (the JAX einsum path)."""
    dots = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    attn = torch.softmax(dots, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernel library; returns the C entry."""
    lib = build.load(SOURCE)
    fn = lib.mocha_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_attention: {name} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"fused_attention: {name} must be 4-D "
                             f"(B, H, rows, d), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("fused_attention: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"fused_attention: {name} needs a unit stride "
                             "in its last dimension")
        step = ALIGN_BYTES // t.element_size()
        if t.data_ptr() % ALIGN_BYTES or any(
                n > 1 and s % step for n, s in zip(t.shape[:3],
                                                   t.stride()[:3])):
            raise ValueError(
                f"fused_attention: {name} needs a {ALIGN_BYTES}-byte-aligned"
                f" start and (batch, head, row) strides in multiples of "
                f"{step} elements; got offset {t.data_ptr() % ALIGN_BYTES} "
                f"bytes, strides {t.stride()}")
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not (1 <= m <= MAX_KEYS) or d % HEAD_DIM_MULTIPLE or d == 0 or n == 0:
        raise ValueError(
            f"fused_attention: the kernel takes 1 <= M <= {MAX_KEYS} keys and"
            f" d a positive multiple of {HEAD_DIM_MULTIPLE}; got M={m}, d={d},"
            f" N={n}")


def fused_attention(q, k, v, *, scale: float):
    """softmax(q k^T * scale) v.  Inputs need a unit last stride; other
    strides are free (the generator passes (B, N, H, d) projections viewed
    as (B, H, N, d)).  The output is a (B, H, N, d) view of a (B, N, H, d)
    buffer, so ``out.transpose(1, 2)`` is contiguous."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    _check(q, k, v)
    fn = load_library()
    b, h, n, d = q.shape
    m = k.shape[2]
    out = torch.empty((b, n, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *strides, b, h, n, m, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"fused_attention: CUDA launch failed with error "
                           f"{err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
