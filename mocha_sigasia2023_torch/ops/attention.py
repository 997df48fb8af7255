"""Fused attention: the CUDA kernels, their plain version, and the wrapper.

Counterpart of mocha_sigasia2023_tpu/ops/attention.py (the Pallas kernel
``_attn_kernel``).  ``fused_attention`` computes softmax(q k^T * scale) v
for (B, H, N, d) queries and (B, H, M, d) keys/values:

* on a CUDA tensor it launches a kernel or raises — there is no fallback.
  :func:`_route` picks the kernel from the shapes and the layout alone:
  inside the tuned envelope (1 <= M <= 128 keys, d a positive multiple of
  64, 16-byte-aligned starts and strides, as TMA copies them)
  ``csrc/attention.cu`` for float32 (products in 3xTF32 on the tensor
  cores) and ``csrc/attention_bf16.cu`` for bfloat16 (bf16 tensor-core
  products, P and the output rounded to bf16 as the TPU kernel rounds
  them); outside it ``csrc/attention_general.cu`` in either dtype (fp32
  FMA on the CUDA cores, any N, M, d and element strides);
* on a CPU tensor it runs :func:`attention_reference`, the plain form of
  the same arithmetic.

``fused_attention.launches`` counts tuned float32 kernel launches,
``fused_attention.launches_bf16`` tuned bfloat16 ones and
``fused_attention.launches_general`` those of the general kernel in either
dtype (CPU calls do not count), so a run can show which kernel it went
through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "attention.cu"
SOURCE_BF16 = "attention_bf16.cu"
SOURCE_GENERAL = "attention_general.cu"
SOURCES = (SOURCE, SOURCE_BF16, SOURCE_GENERAL)
# the tuned kernels: dtype -> (source, C entry, launch counter)
KERNELS = {
    torch.float32: (SOURCE, "mocha_attention_f32", "launches"),
    torch.bfloat16: (SOURCE_BF16, "mocha_attention_bf16", "launches_bf16"),
}
# the general kernel, one source with an entry per dtype
GENERAL = {
    torch.float32: (SOURCE_GENERAL, "mocha_attention_general_f32",
                    "launches_general"),
    torch.bfloat16: (SOURCE_GENERAL, "mocha_attention_general_bf16",
                     "launches_general"),
}
ROUTES = {"tuned": KERNELS, "general": GENERAL}
MAX_KEYS = 128
HEAD_DIM_MULTIPLE = 64
# the kernels' TMA copies need 16-byte-aligned starts and strides
ALIGN_BYTES = 16


def attention_reference(q, k, v, scale: float):
    """Plain PyTorch softmax(q k^T * scale) v.  Float32 inputs take the
    JAX package's einsum path; bfloat16 inputs take the TPU kernel's
    arithmetic: float32 logits and softmax, P rounded to bf16, P v summed in
    float32, the output rounded to bf16."""
    if q.dtype == torch.bfloat16:
        dots = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
        p = torch.softmax(dots, dim=-1).to(torch.bfloat16)
        return torch.einsum("bhnm,bhmd->bhnd", p.float(),
                            v.float()).to(torch.bfloat16)
    dots = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    attn = torch.softmax(dots, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


@functools.lru_cache(maxsize=None)
def load_library(dtype=torch.float32, route="tuned"):
    """Build (if needed) and load the ``route`` kernel ("tuned" or
    "general") for ``dtype``; returns its C entry."""
    source, name, _ = ROUTES[route][dtype]
    fn = getattr(build.load(source), name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    """Raise on what no kernel takes: another dtype, mismatched shapes or
    devices, a rank other than 4, a non-unit last stride, an empty
    dimension."""
    if q.dtype not in KERNELS:
        raise TypeError(f"fused_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"fused_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"fused_attention: {name} must be 4-D "
                             f"(B, H, rows, d), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("fused_attention: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"fused_attention: {name} needs a unit stride "
                             "in its last dimension")
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if min(b, h, n, m, d) == 0:
        raise ValueError(f"fused_attention: empty dimension in q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


def _aligned(t) -> bool:
    """A 16-byte-aligned start and (batch, head, row) strides, as the tuned
    kernels' TMA copies need (a dimension of extent 1 is never stepped)."""
    step = ALIGN_BYTES // t.element_size()
    return t.data_ptr() % ALIGN_BYTES == 0 and not any(
        n > 1 and s % step for n, s in zip(t.shape[:3], t.stride()[:3]))


def _route(q, k, v) -> str:
    """Return "tuned" for what the tuned kernels take (1 <= M <= 128 keys, d a
    positive multiple of 64, every view aligned for TMA), else "general".
    Shapes and layout alone decide it; call it on inputs ``_check``
    accepts."""
    m, d = k.shape[2], q.shape[3]
    if (1 <= m <= MAX_KEYS and d % HEAD_DIM_MULTIPLE == 0
            and all(_aligned(t) for t in (q, k, v))):
        return "tuned"
    return "general"


def fused_attention(q, k, v, *, scale: float):
    """softmax(q k^T * scale) v in q's dtype (float32 or bfloat16).  Inputs
    need a unit last stride; other strides are free (the generator passes
    (B, N, H, d) projections viewed as (B, H, N, d)).  The output is a
    (B, H, N, d) view of a (B, N, H, d) buffer, so ``out.transpose(1, 2)``
    is contiguous."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    _check(q, k, v)
    route = _route(q, k, v)
    fn = load_library(q.dtype, route)
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
    counter = ROUTES[route][q.dtype][2]
    setattr(fused_attention, counter, getattr(fused_attention, counter) + 1)
    return out


fused_attention.launches = 0
fused_attention.launches_bf16 = 0
fused_attention.launches_general = 0
