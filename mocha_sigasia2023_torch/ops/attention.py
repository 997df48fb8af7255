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
  them); outside it ``csrc/attention_general.cu`` in either dtype
  (tensor-core products, logits computed once where they fit in shared
  memory, asynchronous copies; any N, M, d and element strides), laid out
  by :func:`general_plan`;
* on a CPU tensor it runs :func:`attention_reference`, the plain form of
  the same arithmetic;
* on an input that requires grad under grad mode it raises, on every
  device: the kernels have no backward.  Training takes the plain formula.

``fused_attention.launches`` counts tuned float32 kernel launches,
``fused_attention.launches_bf16`` tuned bfloat16 ones and
``fused_attention.launches_general`` those of the general kernel in either
dtype (CPU calls do not count), so a run can show which kernel it went
through.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from ..utils.profiling import recording, span
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
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
MAX_KEYS = 128
HEAD_DIM_MULTIPLE = 64
# the kernels' TMA copies need 16-byte-aligned starts and strides
ALIGN_BYTES = 16

# the general kernel's tiles: keys a staged tile of k or v (four 8-key MMA
# tiles), query rows a CTA at most (16 a warp), head-dim columns of q and
# k staged at a time, output columns held in registers at a time
GENERAL_KEYS = 32
GENERAL_ROWS = 64
GENERAL_CHUNK = 128
GENERAL_COL_BLOCK = 128
# an H100's dynamic shared memory a block may use, and an SM's (of which
# each resident block also takes 1 KB)
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
# the general kernel keeps its logits resident only in a CTA of at most
# this much shared memory: half an SM, so that two CTAs share one
GENERAL_RESIDENT_SMEM = SM_SMEM // 2 - 1024


@dataclass(frozen=True)
class GeneralPlan:
    """How ``csrc/attention_general.cu`` lays out one call, passed to its C
    entry field by field (the order of ``astuple``).  Widths and strides
    are in elements of the inputs' dtype, ``smem`` in bytes."""

    rows: int          # query rows a CTA (a multiple of 16)
    depth: int         # d rounded up to the MMA depth (8 fp32, 16 bf16)
    chunk: int         # head-dim columns of a staged k (and q) chunk
    chunks: int        # chunks over ``depth``; q stays resident if 1
    col_block: int     # output columns a pass of P v holds in registers
    col_blocks: int
    q_stride: int      # row stride of the resident q tile (0 if chunked)
    c_stride: int      # row stride of a staged q or k chunk
    v_stride: int      # row stride of a staged v tile
    buffer: int        # elements of each of the two staging buffers
    keys: int          # M rounded up to GENERAL_KEYS
    resident: int      # 1: the fp32 logits of the CTA's rows stay in
    # shared memory (computed once); 0: two passes over the keys
    smem: int


def _smem_stride(cols: int, esize: int) -> int:
    """A staged row's stride in elements: rows 16 bytes apart modulo 128
    (fp32: the fragment loads g * stride + t hit 32 banks) or an odd
    multiple of 16 bytes (bf16: ldmatrix's eight rows hit every bank)."""
    nbytes = cols * esize
    nbytes += (16 - nbytes) % 128 if esize == 4 else 16
    return nbytes // esize


def _buffer_parts(rows, chunks, c_stride, v_stride):
    """Elements of a staged k chunk (after its q chunk when d takes more
    than one) and of a staged v block."""
    return ((rows if chunks > 1 else 0) + GENERAL_KEYS) * c_stride, \
        GENERAL_KEYS * v_stride


def general_plan(n: int, m: int, d: int, dtype) -> GeneralPlan:
    """The general kernel's layout for (N, M, d) in ``dtype``.

    A CTA owns min(64, N rounded up to 16) query rows and all of d.  The
    head dim is padded with zeros to the MMA depth and staged in chunks of
    up to 128 columns; with one chunk q is staged once and stays, with more
    q is staged beside each k chunk.  k and v stream through two buffers
    in tiles of 32 keys, v in column blocks of 32, 64, 96 or 128 columns
    (zeros past d; one kernel instance each); on the two-pass path a
    buffer holds a key tile's last k chunk and its v block together.

    The path: the logits stay resident (fp32, computed once; the row max
    and sum and P = e / sum in v's dtype then come from shared memory, and
    P v runs over every column block without computing a logit again)
    whenever q, two buffers and rows x (M rounded up to 32) fp32 logits
    fit in GENERAL_RESIDENT_SMEM bytes, half an SM, so that two CTAs
    share one (general_resident_keys gives that M); above it, two passes
    (the max and sum, then P and P v, logits computed again for each
    column block), which have more CTAs an SM to hide their latency.
    Shared memory never exceeds SMEM_LIMIT, whatever N, M and d are."""
    esize = torch.empty((), dtype=dtype).element_size()
    step = 8 if esize == 4 else 16
    depth = -(-d // step) * step
    chunks = -(-depth // GENERAL_CHUNK)
    chunk = min(depth, GENERAL_CHUNK)
    # column blocks of 32, 64, 96 or 128 columns, the instance's tiles
    col_blocks = -(-depth // GENERAL_COL_BLOCK)
    col_block = min(GENERAL_COL_BLOCK, -(-depth // 32) * 32)
    rows = min(GENERAL_ROWS, -(-n // 16) * 16)
    keys = -(-m // GENERAL_KEYS) * GENERAL_KEYS
    q_stride = _smem_stride(depth, esize) if chunks == 1 else 0
    c_stride = _smem_stride(chunk, esize)
    v_stride = _smem_stride(col_block, esize)
    k_part, v_part = _buffer_parts(rows, chunks, c_stride, v_stride)
    logits = rows * keys * 4
    resident = (rows * q_stride + 2 * max(k_part, v_part)) * esize \
        + logits <= GENERAL_RESIDENT_SMEM
    buffer = max(k_part, v_part) if resident else k_part + v_part
    return GeneralPlan(rows, depth, chunk, chunks, col_block, col_blocks,
                       q_stride, c_stride, v_stride, buffer, keys,
                       int(resident),
                       (rows * q_stride + 2 * buffer) * esize
                       + logits * resident)


def general_resident_keys(n: int, d: int, dtype) -> int:
    """The largest M whose logits stay resident at (N, d) in ``dtype``:
    one key more takes the two-pass path."""
    p = general_plan(n, 1, d, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    staged = (p.rows * p.q_stride + 2 * max(_buffer_parts(
        p.rows, p.chunks, p.c_stride, p.v_stride))) * esize
    return (GENERAL_RESIDENT_SMEM - staged) // (p.rows * 4) \
        // GENERAL_KEYS * GENERAL_KEYS


def attention_reference(q, k, v, scale: float, weights_fn=None):
    """Plain PyTorch softmax(q k^T * scale) v.  Float32 inputs take the
    JAX package's einsum path; bfloat16 inputs take the TPU kernel's
    arithmetic: float32 logits and softmax, P rounded to bf16, P v summed in
    float32, the output rounded to bf16.  ``weights_fn``, when given, maps
    the softmax weights before the product with v (training's dropout)."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k = q.float(), k.float()
    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale,
                         dim=-1)
    if weights_fn is not None:
        attn = weights_fn(attn)
    if bf16:
        return torch.einsum("bhnm,bhmd->bhnd", attn.to(torch.bfloat16).float(),
                            v.float()).to(torch.bfloat16)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


@functools.lru_cache(maxsize=None)
def load_library(dtype=torch.float32, route="tuned"):
    """Build (if needed) and load the ``route`` kernel ("tuned" or
    "general") for ``dtype``; returns its C entry."""
    source, name, _ = ROUTES[route][dtype]
    fn = getattr(build.load(source), name)
    # the general entries also take the plan, an int array
    plan = [ctypes.POINTER(ctypes.c_int)] if route == "general" else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + plan
                   + [ctypes.c_void_p])
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
    is contiguous.

    The kernels have no backward (nor has the TPU kernel), and their output
    carries no gradient: an input that requires one under grad mode raises,
    on every device, so that a forward to be differentiated cannot reach a
    kernel on the card while the CPU's plain version quietly differentiates.
    Such a forward takes the plain formula, ``models.layers.attention(...,
    train=True)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "fused_attention: an input requires grad, but the kernels have "
            "no backward; differentiate through the training forward "
            "(models.layers.attention(..., train=True)) or run under "
            "torch.no_grad()")
    if q.device.type == "cpu":
        with _span(q, k, "plain"):
            return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    _check(q, k, v)
    route = _route(q, k, v)
    with _span(q, k, route):
        return _launch(q, k, v, scale, route)


def _span(q, k, route):
    """The call's ``ops.attention`` span, with B, H, N, M, d, the dtype's
    name and the route ("tuned", "general", or "plain" on the CPU) as its
    attributes, worked out only while spans record."""
    if not recording():
        return span("ops.attention")
    b, h, n, d = q.shape
    return span("ops.attention", B=b, H=h, N=n, M=k.shape[2], d=d,
                dtype=DTYPE_NAMES.get(q.dtype, str(q.dtype)), route=route)


def _launch(q, k, v, scale, route):
    fn = load_library(q.dtype, route)
    b, h, n, d = q.shape
    m = k.shape[2]
    out = torch.empty((b, n, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    plan = []
    if route == "general":
        fields = astuple(general_plan(n, m, d, q.dtype))
        plan = [(ctypes.c_int * len(fields))(*fields)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *strides, b, h, n, m, d, float(scale), *plan, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention: CUDA launch failed with error "
                           f"{err}")
    counter = ROUTES[route][q.dtype][2]
    setattr(fused_attention, counter, getattr(fused_attention, counter) + 1)
    return out


fused_attention.launches = 0
fused_attention.launches_bf16 = 0
fused_attention.launches_general = 0
